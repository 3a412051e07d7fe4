"""Evaluation entry point of the port (counterpart of
ppmstereo_tpu/cli/evaluate.py): dataset selection, the zoo's predictor with
its window modes, sequence evaluation, a JSON dump.

    python -m ppmstereo_tpu_torch.cli.evaluate \\
        --config ppmstereo_tpu_torch/configs/eval_dynamic_replica_40_frames.yaml \\
        dataset_root=datasets MODEL.checkpoint=checkpoints/anchor_r5.npz

    python -m ppmstereo_tpu_torch.cli.evaluate \
        --config ppmstereo_tpu_torch/configs/eval_real.yaml   # DynamicStereoModel

Trailing KEY=VALUE arguments override the config (dotted for MODEL.*).
Runs on `cuda` unless `--device` names another device; raises without a
card. MODEL.model_name is any model of the port's zoo (PPMStereoModel,
DynamicStereoModel, RAFTStereoModel, BiDAStereoModel). MODEL.checkpoint
takes the flat parameters (.npz) of that model (the JAX package's, or what
either package's import_torch CLI wrote) or a directory of the port's
trainer (its newest step_<n>.pt); without one the model runs from the
port's seeded initialisation. MODEL.model_kwargs ("k=v,k2=v2", values
literal-evaluated) reaches the model zoo: the window modes (warm_start,
warm_iters, encoder_cache: PPMStereoModel only) and every field of the
model's config (mixed_precision, use_cnet, top_k, corr_radius, ...).
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
from dataclasses import dataclass, field

import torch

from ppmstereo_tpu_torch.models.zoo import model_zoo


@dataclass
class ModelConfig:
    model_name: str = "PPMStereoModel"
    kernel_size: int = 20
    iters: int = 20
    checkpoint: str = ""
    fast_mode: bool = False  # non-overlapping windows (non-parity)
    batch_windows: int = 1  # windows of one length per batch (strict)
    # a (data, seq, space) mesh such as "1x1x2": not in this one-process CLI
    mesh: str = ""
    # extra model-constructor kwargs as "k=v,k2=v2" (values literal-evaluated)
    model_kwargs: str = ""


def _parse_model_kwargs(spec: str) -> dict:
    out = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        k, _, v = item.partition("=")
        try:
            out[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            out[k.strip()] = v.strip()
    return out


@dataclass
class DefaultConfig:
    exp_dir: str = "./outputs/eval"
    dataset_name: str = "dynamicreplica"  # | sintel | things | synthetic | infinigen | kitti | real
    dstype: str = "clean"  # sintel pass
    dataset_root: str = "datasets"
    sample_len: int = 40
    only_first_n_samples: int = 1
    crop: int = 0
    MODEL: ModelConfig = field(default_factory=ModelConfig)


def build_dataset(cfg: DefaultConfig):
    from ppmstereo_tpu_torch.data import datasets as D

    name, root = cfg.dataset_name, cfg.dataset_root
    if name == "dynamicreplica":
        return D.DynamicReplicaDataset(root=f"{root}/dynamic_replica_data", split="valid",
                                       sample_len=cfg.sample_len,
                                       only_first_n_samples=cfg.only_first_n_samples)
    if name == "sintel":
        return D.SequenceSintelStereo(dstype=cfg.dstype, root=f"{root}/sintel_stereo")
    if name == "things":
        return D.SequenceSceneFlowDataset(root=f"{root}/SceneFlow", dstype="frames_finalpass",
                                          sample_len=cfg.sample_len, things_test=True)
    if name == "synthetic":
        return D.SyntheticStereoDataset(num_seqs=2, sample_len=cfg.sample_len, height=256,
                                        width=384)
    if name == "infinigen":
        return D.InfinigenStereoVideoDataset(root=f"{root}/infinigen_stereo",
                                             sample_len=cfg.sample_len)
    if name == "kitti":
        return D.KITTIDepthDataset(root=f"{root}/kitti_depth", split="val",
                                   sample_len=cfg.sample_len)
    raise ValueError(f"unknown dataset {name}")


# the real ZED captures of the 'real' dataset, in Dynamic Replica's layout
REAL_SEQUENCES = ("teddy_static", "ignacio_waving", "nikita_reading")


def _run_real_eval(cfg: DefaultConfig, predictor, evaluator):
    """Each real capture found under the dataset root (no ground truth:
    fps only)."""
    from ppmstereo_tpu_torch.data.datasets import DynamicReplicaDataset
    from ppmstereo_tpu_torch.evaluation.evaluator import pretty_print_results

    all_results = {}
    for seq_name in REAL_SEQUENCES:
        root = f"{cfg.dataset_root}/dynamic_replica_data/real/{seq_name}"
        if not os.path.isdir(root):
            logging.warning(f"real sequence {root} not found; skipping")
            continue
        ds = DynamicReplicaDataset(root=root, split="test", sample_len=cfg.sample_len,
                                   only_first_n_samples=1)
        results = evaluator.evaluate_sequence(predictor, ds)
        evaluator.dump(results, f"real_{seq_name}")
        pretty_print_results(results)
        all_results[seq_name] = results
    return all_results


def load_checkpoint(predictor, path: str) -> None:
    """Parameters from the JAX package's flat .npz or the newest step_<n>.pt
    of the port's trainer directory, into the predictor's model."""
    from ppmstereo_tpu_torch.train.checkpoints import CheckpointManager
    from ppmstereo_tpu_torch.utils.weights import load_npz, state_dict_to_flax

    if path.endswith(".npz"):
        predictor.load_params(load_npz(path))
        return
    if not os.path.isdir(path):
        raise FileNotFoundError(f"MODEL.checkpoint {path}: not an .npz file or a directory")
    steps = CheckpointManager(path).steps()
    if not steps:
        raise FileNotFoundError(f"no step_<n>.pt checkpoint in {path}")
    saved = torch.load(os.path.join(path, f"step_{steps[-1]}.pt"), map_location="cpu",
                       weights_only=True)
    predictor.load_params(state_dict_to_flax(saved["model"]))


def run_eval(cfg: DefaultConfig, device: str = "cuda"):
    from ppmstereo_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        Evaluator,
        pretty_print_results,
    )

    if cfg.MODEL.mesh:
        raise NotImplementedError(
            f"MODEL.mesh={cfg.MODEL.mesh}: the port's sharded inference runs one process per "
            "rank, and this CLI is one process; the data and seq axes and a sharded "
            "evaluation are ROADMAP §1 item 7.2")
    kwargs = _parse_model_kwargs(cfg.MODEL.model_kwargs)
    kwargs.setdefault("device", device)
    predictor = model_zoo(cfg.MODEL.model_name, kernel_size=cfg.MODEL.kernel_size,
                          iters=cfg.MODEL.iters, fast_mode=cfg.MODEL.fast_mode,
                          batch_windows=cfg.MODEL.batch_windows, **kwargs)
    if cfg.MODEL.checkpoint:
        load_checkpoint(predictor, cfg.MODEL.checkpoint)

    evaluator = Evaluator(EvalConfig(exp_dir=cfg.exp_dir, crop=cfg.crop))
    if cfg.dataset_name == "real":
        return _run_real_eval(cfg, predictor, evaluator)
    dataset = build_dataset(cfg)
    results = evaluator.evaluate_sequence(predictor, dataset)
    path = evaluator.dump(results, cfg.dataset_name)
    pretty_print_results(results)
    logging.info(f"results -> {path}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser("ppmstereo_tpu_torch.evaluate")
    p.add_argument("--device", default="cuda", help="torch device (cuda | cuda:N | cpu)")
    p.add_argument("--config", default=None, help="a YAML preset (configs/*.yaml)")
    p.add_argument("overrides", nargs="*", help="KEY=VALUE overrides, dotted for MODEL.*")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ppmstereo_tpu_torch.utils.config import apply_overrides, load_yaml

    if args.config:
        cfg = load_yaml(DefaultConfig, args.config, overrides=args.overrides)
    else:
        cfg = apply_overrides(DefaultConfig(), args.overrides)
    return run_eval(cfg, device=args.device)


if __name__ == "__main__":
    main()
