"""Evaluation with the sequences spread over processes (counterpart of
ppmstereo_tpu/evaluation/distributed.py): each rank runs its share of the
dataset's sequences, and the length-weighted metric sums are all-reduced,
so every rank returns the global means, the aggregate of
`Evaluator.evaluate_sequence` over the whole dataset.

Each rank's predictor is built without a mesh: the ranks run different
numbers of windows, so a collective inside the model would leave a group
waiting.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ppmstereo_tpu_torch.evaluation.metrics import BAD_PX, eval_endpoint_error_sequence

# every metric of eval_endpoint_error_sequence: each rank sends all of
# them, whether or not its sequences have ground truth
METRICS = tuple(sorted(f"{name}_{stat}" for name in ("epe", "temp_epe")
                       for stat in ("mean", *(f"bad_{key}" for _, key in BAD_PX))))


def shard_sequences(num_sequences: int, process_index: int, process_count: int) -> list[int]:
    """The sequences of one rank: every process_count-th from its index
    (a strided split, as the JAX package's code makes it)."""
    return list(range(process_index, num_sequences, process_count))


def allreduce_weighted_metrics(local_sums: dict[str, float], local_weight: float,
                               group=None) -> dict[str, float]:
    """Sum the ranks' accumulators (sum of metric x sequence length over
    the sequences with ground truth, and the frames of all) over `group`
    (the default group when None; none without a group) and return the
    global means with `total_frames`. Every rank sends every metric of
    METRICS and a count of the ranks that had one, so the messages match;
    the metrics appear where some rank had them, as in the JAX package."""
    unknown = set(local_sums) - set(METRICS)
    if unknown:
        raise ValueError(f"metrics {sorted(unknown)} are not in METRICS")
    vec = torch.tensor([local_sums.get(k, 0.0) for k in METRICS]
                       + [float(bool(local_sums)), local_weight], dtype=torch.float64)
    if dist.is_initialized():
        if dist.get_backend(group) == "nccl":  # NCCL moves device tensors only
            vec = vec.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(vec, group=group)
        vec = vec.cpu()
    total_w = float(vec[-1])
    out = {}
    if vec[-2] > 0:
        out = {k: float(vec[i]) / max(total_w, 1e-9) for i, k in enumerate(METRICS)}
    out["total_frames"] = total_w
    return out


def evaluate_distributed(evaluator, predictor, dataset, group=None) -> dict:
    """This rank's sequences through `predictor` (`shard_sequences` over the
    ranks of `group`, the default group when None), the metrics reduced
    over the group. `evaluator` is unused (the JAX signature's)."""
    del evaluator
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    local_sums: dict[str, float] = {}
    local_weight = 0.0
    for i in shard_sequences(len(dataset), rank, world):
        sample = dataset[i]
        out = predictor({"stereo_video": sample["img"]})
        seq_len = len(sample["img"])
        if sample.get("disp") is not None:
            res = eval_endpoint_error_sequence(out["disparity"], np.abs(sample["disp"][:, 0]),
                                               sample["valid"][:, 0][..., None])
            for k, v in res.items():
                local_sums[k] = local_sums.get(k, 0.0) + float(v) * seq_len
        local_weight += seq_len
    return allreduce_weighted_metrics(local_sums, local_weight, group)
