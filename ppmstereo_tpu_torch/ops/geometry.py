"""Stateless geometric primitives on channels-last tensors.

Counterpart of ppmstereo_tpu/ops/geometry.py: the same functions on
(..., H, W, C) tensors. The linear resizes keep the JAX package's form, a
contraction with a constant two-tap matrix held in the input's dtype, so a
bf16 input sees the same bf16 tap weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def coords_grid_x(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """Per-pixel x coordinate, f32, shape (batch, ht, wd)."""
    x = torch.arange(wd, device=device, dtype=torch.float32)
    return x.expand(batch, ht, wd)


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(in_size, out_size) two-tap linear interpolation matrix matching
    torch F.interpolate(mode="bilinear") tap positions for the given
    align_corners flag (clip-to-edge out-of-range taps)."""
    if align_corners:
        if out_size == 1 or in_size == 1:
            pos = np.zeros((out_size,), dtype=np.float64)
        else:
            pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        pos = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
    i0 = np.floor(pos).astype(np.int64)
    w1 = (pos - i0).astype(np.float32)
    i0c = np.clip(i0, 0, in_size - 1)
    i1c = np.clip(i0 + 1, 0, in_size - 1)
    cols = np.arange(out_size)
    mat = np.zeros((in_size, out_size), dtype=np.float32)
    np.add.at(mat, (i0c, cols), 1.0 - w1)
    np.add.at(mat, (i1c, cols), w1)
    return mat


def two_tap_resize_1d(x: torch.Tensor, axis: int, out_size: int,
                      align_corners: bool) -> torch.Tensor:
    """Linear resize along one axis (torch interp semantics) as a product
    with a constant matrix whose columns hold the two lerp taps."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    mat = torch.from_numpy(_resize_matrix(in_size, out_size, align_corners))
    mat = mat.to(device=x.device, dtype=x.dtype)
    y = torch.matmul(x.movedim(axis, -1), mat)
    return y.movedim(-1, axis)


def interp_ac_false(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=False resize of (..., H, W, C) to out_hw."""
    h, w = out_hw
    x = two_tap_resize_1d(x, x.dim() - 3, h, align_corners=False)
    return two_tap_resize_1d(x, x.dim() - 2, w, align_corners=False)


def interp_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of (..., H, W, C) to out_hw."""
    h, w = out_hw
    x = two_tap_resize_1d(x, x.dim() - 3, h, align_corners=True)
    return two_tap_resize_1d(x, x.dim() - 2, w, align_corners=True)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of (..., H, W, C)."""
    x = torch.repeat_interleave(x, 2, dim=x.dim() - 3)
    return torch.repeat_interleave(x, 2, dim=x.dim() - 2)


def avg_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Average pool over the (H, W) axes of (..., H, W, C) with stride ==
    window (the only case the model uses): a reshape and a mean."""
    *lead, h, w, c = x.shape
    hh, ww = h // window, w // window
    x = x[..., : hh * window, : ww * window, :]
    x = x.reshape(*lead, hh, window, ww, window, c)
    return x.mean(dim=(-4, -2))


def avg_pool_w(x: torch.Tensor) -> torch.Tensor:
    """Average pool by 2 along the last axis (the 1-D correlation pyramid)."""
    *lead, n = x.shape
    half = n // 2
    return x[..., : half * 2].reshape(*lead, half, 2).mean(dim=-1)


def _adaptive_bounds(in_size: int, out_size: int) -> list[tuple[int, int]]:
    return [
        (int(np.floor(i * in_size / out_size)), int(np.ceil((i + 1) * in_size / out_size)))
        for i in range(out_size)
    ]


def adaptive_max_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch nn.AdaptiveMaxPool2d semantics on (..., H, W, C)."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = out_hw
    if h_in % h_out == 0 and w_in % w_out == 0:
        *lead, _, _, c = x.shape
        xr = x.reshape(*lead, h_out, h_in // h_out, w_out, w_in // w_out, c)
        return xr.amax(dim=(-4, -2))
    h_axis, w_axis = x.dim() - 3, x.dim() - 2
    x = torch.stack(
        [x.narrow(h_axis, s, e - s).amax(dim=h_axis) for s, e in _adaptive_bounds(h_in, h_out)],
        dim=h_axis,
    )
    return torch.stack(
        [x.narrow(w_axis, s, e - s).amax(dim=w_axis) for s, e in _adaptive_bounds(w_in, w_out)],
        dim=w_axis,
    )


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity: a (B,T,D), b (B,T,D) -> (B,T,T), with
    out[b, i, j] = cos(a[b, j], b[b, i])."""
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(eps)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(eps)
    return torch.einsum("bjd,bid->bij", an, bn)
