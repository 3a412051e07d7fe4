"""All-pairs 1-D (epipolar) correlation volume and its pyramid lookup.

Counterpart of ppmstereo_tpu/ops/corr.py for the PPMStereo path. The lookup
is the two-tap gather form (`_lookup_level_gather`) in plain PyTorch, as the
JAX model leaves its lookup to XLA. It is the plain version of kernel 6,
`kernels/corr_lookup.py` (the counterpart of the JAX package's Pallas lookup
kernel), which the model runs in test mode; train mode runs this lookup,
which autograd differentiates.

Tensors are channels-last. fmap: (B, H, W, C). volume: (B, H, W1, W2).
"""

from __future__ import annotations

import math

import torch

from ppmstereo_tpu_torch.ops.geometry import avg_pool_w


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(B,H,W1,C) x (B,H,W2,C) -> (B,H,W1,W2) / sqrt(C), accumulated in f32
    and stored in the feature dtype."""
    c = fmap1.shape[-1]
    corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return (corr / math.sqrt(c)).to(fmap1.dtype)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> list[torch.Tensor]:
    """Level i has W2 / 2^i columns."""
    corr = corr_volume(fmap1, fmap2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool_w(corr)
        pyramid.append(corr)
    return pyramid


def _lookup_level_gather(corr: torch.Tensor, x: torch.Tensor, radius: int) -> torch.Tensor:
    """Linear interpolation of each row of `corr` at x + [-r, r], zeros
    outside [0, W2): grid_sample with align_corners=True along one axis."""
    w2 = corr.shape[-1]
    dx = torch.arange(-radius, radius + 1, device=x.device, dtype=torch.float32)
    pos = x[..., None].float() + dx
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    if w2 == 0:  # a level pooled down to no columns reads only zero padding
        return torch.zeros_like(pos)

    def tap(idx):
        valid = (idx >= 0) & (idx < w2)
        vals = torch.gather(corr, -1, idx.clamp(0, w2 - 1))
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    return tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac


def corr_lookup(pyramid: list[torch.Tensor], coords_x: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """coords_x (B,H,W1) -> (B,H,W1, L*(2r+1)) f32 features, level-major,
    then dx in [-r, r]."""
    return torch.cat(
        [_lookup_level_gather(corr, coords_x / (2.0**i), radius)
         for i, corr in enumerate(pyramid)],
        dim=-1,
    )
