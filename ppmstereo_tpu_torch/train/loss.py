"""Sequence loss over every refinement iteration, and the train metrics
(counterpart of ppmstereo_tpu/train/loss.py::sequence_loss).

A gamma-weighted L1 over all n iteration outputs with
adjusted_gamma = 0.9^(15 / (n - 1)), a valid mask that also excludes
|disparity| >= 700, and the uncertainty target
|exp(-0.9 |err| / 7) + 1e-2 - uncertainty|. Masked means are sum / sum.
"""

from __future__ import annotations

import torch

LOSS_GAMMA = 0.9
MAX_FLOW = 700.0


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dims=None) -> torch.Tensor:
    if dims is None:
        return (x * mask).sum() / mask.sum().clamp_min(1.0)
    return (x * mask).sum(dim=dims) / mask.sum().clamp_min(1.0)


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  uncertainties: torch.Tensor | None = None):
    """flow_preds (n, B, T, H, W, 1) disparity-x predictions; flow_gt
    (B, T, H, W, C) with the x component first; valid (B, T, H, W) or
    (B, T, H, W, 1); uncertainties optional, like flow_preds.

    Returns (loss, metrics): metrics are 0-d tensors epe, 1px, 3px, 5px."""
    flow_preds = flow_preds.float()
    flow_gt = flow_gt.float()[..., :1]
    if valid.dim() == flow_gt.dim() - 1:
        valid = valid[..., None]
    valid = valid.float() * (flow_gt.abs() < MAX_FLOW).float()

    n = flow_preds.shape[0]
    steps = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=flow_preds.device)
    weights = (LOSS_GAMMA ** (15.0 / (n - 1))) ** steps if n > 1 else torch.ones_like(steps)

    err = (flow_preds - flow_gt[None]).abs()  # (n, B, T, H, W, 1)
    per_iter = err
    if uncertainties is not None:
        gt_unc = torch.exp(-0.9 * err / 7.0) + 1e-2
        per_iter = err + (gt_unc - uncertainties.float()).abs()
    dims = tuple(range(1, per_iter.dim()))
    flow_loss = (weights * _masked_mean(per_iter, valid, dims)).sum()

    epe = (flow_preds[-1] - flow_gt).abs().detach()
    metrics = {
        "epe": _masked_mean(epe, valid),
        "1px": _masked_mean((epe > 1).float(), valid) * 100,
        "3px": _masked_mean((epe > 3).float(), valid) * 100,
        "5px": _masked_mean((epe > 5).float(), valid) * 100,
    }
    return flow_loss, metrics
