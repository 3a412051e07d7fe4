"""RAFT-style 3-D convex upsampling, channels-last.

Counterpart of ppmstereo_tpu/ops/upsample.py: the 3-D variant of the
shipped config and the 2-D one of `use_convex_3d=False`. Mask channels are
laid out as [tap(27 or 9), ry, rx], taps row-major over the (dt, dy, dx)
or (dy, dx) offsets in {-1, 0, 1}, zero padding. On one rank's frames of
a window spread over the seq axis, the 3-D variant takes its time
neighbours from a halo of one frame (`parallel/sharding.py::FrameShard`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighborhood_2d(x: torch.Tensor) -> torch.Tensor:
    """Stack the 3x3 zero-padded neighbourhood: (B,H,W,C) -> (B,H,W,9,C)."""
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy: dy + h, dx: dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=-2)


def _neighborhood_3d(x: torch.Tensor, shard=None) -> torch.Tensor:
    """Stack the 3x3x3 zero-padded neighbourhood: (B,T,H,W,C) -> (B,T,H,W,27,C);
    under a seq `shard` the time neighbours come from the halo."""
    t, h, w = x.shape[-4], x.shape[-3], x.shape[-2]
    if shard is None:
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    else:
        xp = F.pad(shard.halo(x, 1), (0, 0, 1, 1, 1, 1))
    taps = [
        xp[:, dt : dt + t, dy : dy + h, dx : dx + w, :]
        for dt in range(3)
        for dy in range(3)
        for dx in range(3)
    ]
    return torch.stack(taps, dim=-2)


def _pixel_shuffle(up: torch.Tensor, rate: int) -> torch.Tensor:
    """(..., H, W, r*r, C) -> (..., H*r, W*r, C) with [ry, rx] subpixel order."""
    *lead, h, w, _, c = up.shape
    n = len(lead)
    up = up.reshape(*lead, h, w, rate, rate, c)
    up = up.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return up.reshape(*lead, h * rate, w * rate, c)


def convex_upsample_3d(flow: torch.Tensor, mask: torch.Tensor, rate: int = 4,
                       shard=None) -> torch.Tensor:
    """flow (B,T,H,W,2), mask (B,T,H,W,27*r*r) -> (B,T,H*r,W*r,2), in f32.

    Per output subpixel, a softmax-convex combination of the 3x3x3
    neighbourhood of rate * flow; only H and W are upsampled. shard: this
    rank's frames of a window over the seq axis (None: the whole window)."""
    b, t, h, w, _ = flow.shape
    weights = torch.softmax(mask.reshape(b, t, h, w, 27, rate * rate).float(), dim=-2)
    nb = _neighborhood_3d(rate * flow.float(), shard)  # (B,T,H,W,27,2)
    up = torch.einsum("bthwkr,bthwkc->bthwrc", weights, nb)
    return _pixel_shuffle(up, rate)


def convex_upsample_2d(flow: torch.Tensor, mask: torch.Tensor, rate: int = 4) -> torch.Tensor:
    """flow (B,H,W,2), mask (B,H,W,9*r*r) -> (B,H*r,W*r,2), in f32.

    Per output subpixel, a softmax-convex combination of the 3x3
    neighbourhood of rate * flow."""
    b, h, w, _ = flow.shape
    weights = torch.softmax(mask.reshape(b, h, w, 9, rate * rate).float(), dim=-2)
    nb = _neighborhood_2d(rate * flow.float())  # (B,H,W,9,2)
    up = torch.einsum("bhwkr,bhwkc->bhwrc", weights, nb)
    return _pixel_shuffle(up, rate)
