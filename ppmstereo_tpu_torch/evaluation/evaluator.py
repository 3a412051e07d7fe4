"""Sequence evaluator (counterpart of ppmstereo_tpu/evaluation/evaluator.py):
each sequence of a dataset through the predictor, masked EPE / temporal EPE
/ bad-px per sequence, a length-weighted aggregate, a JSON dump.

`fps` is frames over the predictor's wall time; reading the dataset's
frames is not in it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np

from ppmstereo_tpu_torch.evaluation.metrics import (
    aggregate_sequence_results,
    eval_endpoint_error_sequence,
)


@dataclass
class EvalConfig:
    exp_dir: str = "./outputs"  # where dump() and the visualisations write
    crop: int = 0  # border pixels left out of the metrics
    visualize: bool = False  # write point-cloud renders of every sequence


class Evaluator:
    def __init__(self, cfg: EvalConfig | None = None):
        self.cfg = cfg or EvalConfig()

    def evaluate_sequence(self, predictor, dataset) -> dict:
        """predictor: a callable on {"stereo_video": (N, 2, H, W, 3)} such as
        the zoo's StereoVideoPredictor; dataset: samples with img
        (T, 2, H, W, 3) and, where there is ground truth, disp (T, 1, H, W, 1)
        and valid (T, 1, H, W)."""
        per_seq, lengths, per_seq_results = [], [], []
        for i in range(len(dataset)):
            sample = dataset[i]
            video = sample["img"]
            t0 = time.perf_counter()
            out = predictor({"stereo_video": video})
            dt = time.perf_counter() - t0
            seq_len = len(video)
            if self.cfg.visualize:
                from ppmstereo_tpu_torch.evaluation.visualization import save_reconstruction_views

                save_reconstruction_views(np.abs(out["disparity"][..., 0]),
                                          video[:, 0].astype(np.uint8),
                                          os.path.join(self.cfg.exp_dir, "visualisations"),
                                          sequence_name=f"seq_{i}")
            if sample.get("disp") is not None:
                results = eval_endpoint_error_sequence(
                    out["disparity"], np.abs(sample["disp"][:, 0]),
                    sample["valid"][:, 0][..., None], crop=self.cfg.crop)
            else:
                results = {}
            results["fps"] = seq_len / max(dt, 1e-9)
            extra = getattr(dataset, "extra_info", None)
            name = extra[i] if extra else f"seq_{i}"
            logging.info(f"[eval] {name}: {results}")
            per_seq.append(results)
            lengths.append(seq_len)
            per_seq_results.append({"name": str(name), **results})
        agg = aggregate_sequence_results(per_seq, lengths)
        agg["num_sequences"] = len(per_seq)
        return {"aggregate": agg, "per_sequence": per_seq_results}

    def dump(self, results: dict, dataset_name: str, step: int | str = "final") -> str:
        os.makedirs(self.cfg.exp_dir, exist_ok=True)
        path = os.path.join(self.cfg.exp_dir, f"result_{dataset_name}_{step}.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2)
        return path


def pretty_print_results(results: dict) -> None:
    """The aggregate metrics as a two-column table."""
    agg = results.get("aggregate", results)
    width = max((len(k) for k in agg), default=10) + 2
    lines = ["-" * (width + 14)]
    for k in sorted(agg):
        v = agg[k]
        lines.append(f"{k:<{width}}| {v:>10.4f}" if isinstance(v, float) else f"{k:<{width}}| {v}")
    lines.append("-" * (width + 14))
    print("\n".join(lines))
