"""Sequence loss over every refinement iteration, and the train metrics
(counterpart of ppmstereo_tpu/train/loss.py::sequence_loss).

A gamma-weighted L1 over all n iteration outputs with
adjusted_gamma = 0.9^(15 / (n - 1)), a valid mask that also excludes
|disparity| >= 700, and the uncertainty target
|exp(-0.9 |err| / 7) + 1e-2 - uncertainty|. Masked means are sum / sum.

Over the mesh's data and seq axes (`group`, `parallel/mesh.py::
Mesh.replica_group`: each rank holds its block of the global batch's clips
and its block of their frames) every masked mean is the global batch's,
as in the JAX loss under P("data", "seq") sharding: the numerators are the
rank's own, the denominator (which carries no gradient) is all-reduced.
The loss a rank returns is then its share: the ranks' shares add up to the
global loss, and so do their gradients (`train/step.py` sums them). The
metrics are the global batch's on every rank.
"""

from __future__ import annotations

import torch

from ppmstereo_tpu_torch.parallel.collectives import all_reduce_

LOSS_GAMMA = 0.9
MAX_FLOW = 700.0


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  uncertainties: torch.Tensor | None = None, group=None):
    """flow_preds (n, B, T, H, W, 1) disparity-x predictions; flow_gt
    (B, T, H, W, C) with the x component first; valid (B, T, H, W) or
    (B, T, H, W, 1); uncertainties optional, like flow_preds.

    Returns (loss, metrics): metrics are 0-d tensors epe, 1px, 3px, 5px.
    With a `group` (data x seq) the loss is this rank's share of the global
    batch's and the metrics are the global batch's."""
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
    epe = (flow_preds[-1] - flow_gt).abs().detach()
    # the valid count and the metrics' numerators (summed over the group)
    sums = torch.stack([valid.sum()] + [(x * valid).sum() for x in (
        epe, (epe > 1).float(), (epe > 3).float(), (epe > 5).float())])
    if group is not None:
        sums = all_reduce_(sums, group)
    den = sums[0].clamp_min(1.0)
    dims = tuple(range(1, per_iter.dim()))
    flow_loss = (weights * ((per_iter * valid).sum(dim=dims) / den)).sum()
    metrics = {"epe": sums[1] / den, "1px": sums[2] / den * 100, "3px": sums[3] / den * 100,
               "5px": sums[4] / den * 100}
    return flow_loss, metrics
