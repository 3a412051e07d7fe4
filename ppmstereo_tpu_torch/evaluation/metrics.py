"""EPE and temporal EPE of a predicted disparity sequence (counterpart of
ppmstereo_tpu/evaluation/metrics.py), in numpy: the metrics run on the host
after the predictor, off the device's path.

The reference's conventions are kept: the error is masked, the ground
truth's NaNs read as 0, and every rate is over the count of NONZERO error
pixels (zero-error pixels leave the denominator). Per-pixel errors are f32
as in the JAX package; the sums are taken in f64.
"""

from __future__ import annotations

import numpy as np

BAD_PX = ((0.5, "0.5px"), (1.0, "1px"), (2.0, "2px"), (3.0, "3px"))


def eval_endpoint_error_sequence(x, y, mask, crop: int = 0, mask_thr: float = 0.5,
                                 clamp_thr: float = 1e-5) -> dict[str, float]:
    """x (prediction), y (ground truth): (T, H, W, C); mask (T, H, W, 1) in
    [0, 1]. Returns epe_* and temp_epe_*: the mean and the bad-0.5/1/2/3 px
    rates in percent."""
    x, y, mask = (np.asarray(a) for a in (x, y, mask))
    if not x.ndim == y.ndim == mask.ndim == 4:
        raise ValueError(f"expected (T, H, W, C) arrays, got {x.shape}, {y.shape}, {mask.shape}")
    if crop > 0:
        x, y, mask = (a[:, crop:-crop, crop:-crop] for a in (x, y, mask))
    x = x.astype(np.float32)
    y = np.nan_to_num(y.astype(np.float32), nan=0.0)
    mask = mask.astype(np.float32)
    gate = (mask > mask_thr).astype(np.float32)
    y, x = y * gate, x * gate

    results = {}
    for name in ("epe", "temp_epe"):
        if name == "epe":
            err = np.sqrt(np.sum(mask * (x - y) ** 2, axis=-1))
        else:
            dmask = mask[:-1] * mask[1:]
            diff = (x[:-1] - x[1:]) - (y[:-1] - y[1:])
            err = np.sqrt(np.sum(dmask * diff**2, axis=-1))
        nonzero = max(float(np.count_nonzero(err)), clamp_thr)
        results[f"{name}_mean"] = float(err.sum(dtype=np.float64) / nonzero)
        for thr, key in BAD_PX:
            results[f"{name}_bad_{key}"] = float(np.count_nonzero(err > thr) / nonzero * 100.0)
    return results


def aggregate_sequence_results(per_seq: list[dict[str, float]],
                               lengths: list[int]) -> dict[str, float]:
    """The sequence-length-weighted mean of every metric."""
    if not per_seq:
        return {}
    total = float(sum(lengths))
    return {k: float(sum(r[k] * n for r, n in zip(per_seq, lengths)) / total)
            for k in per_seq[0]}
