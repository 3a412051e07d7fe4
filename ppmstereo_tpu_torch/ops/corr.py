"""All-pairs 1-D (epipolar) correlation volume and its pyramid lookup, the
2-D bilinear sampler, BiDAStereo's triple-frame correlation and
StereoAnyVideo's all-in-all-pair correlation.

Counterpart of ppmstereo_tpu/ops/corr.py. The lookup
is the two-tap gather form (`_lookup_level_gather`) in plain PyTorch, as the
JAX model leaves its lookup to XLA. It is the plain version of kernel 6,
`kernels/corr_lookup.py` (the counterpart of the JAX package's Pallas lookup
kernel), which the model runs in test mode; train mode runs this lookup,
which autograd differentiates.

`bilinear_sample_2d`, `tfcl_correlation` and `aapc_correlation` are XLA
code in the JAX package, not Pallas kernels, and stay plain PyTorch here.

Tensors are channels-last. fmap: (B, H, W, C). volume: (B, H, W1, W2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _shift_slice(x_pad: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """The (h, w) window at offset (dy, dx) of a padded (..., H', W', C)."""
    return x_pad[..., dy: dy + h, dx: dx + w, :]


def _edge_pad_hw(x: torch.Tensor, pady: int, padx: int) -> torch.Tensor:
    """Replicate-pad the (H, W) axes of (B, H, W, C)."""
    y = F.pad(x.movedim(-1, 1), (padx, padx, pady, pady), mode="replicate")
    return y.movedim(1, -1)


def bilinear_sample_2d(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B,H,W,C) sampled at coords (B,H',W',2) in pixels, (x, y) order:
    bilinear, zero padding, align-corners semantics (the pixel centre i is at
    coordinate i). Four gathers of the flattened image -> (B,H',W',C), in
    the image's dtype widened with the f32 weights."""
    b, h, w, c = img.shape
    if h * w == 0:  # a pyramid level pooled down to nothing reads only padding
        return torch.zeros(*coords.shape[:-1], c, dtype=img.dtype, device=img.device)
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    img_flat = img.reshape(b, h * w, c)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, -1, 1)
        vals = torch.gather(img_flat, 1, flat.expand(-1, -1, c)).reshape(*ix.shape, c)
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                              device=vals.device))

    return (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)


def tfcl_correlation(left: torch.Tensor, rights_warped, psize: tuple[int, int] = (1, 9)
                     ) -> torch.Tensor:
    """BiDAStereo's triple-frame correlation: left (B,H,W,C) against three
    right features already warped to it, each product of `left` with the
    right feature shifted by (dy, dx) over a py x px patch (replicate
    padding), averaged over channels -> (B,H,W, 3 py px), right-major, then
    dy, then dx."""
    h, w = left.shape[-3], left.shape[-2]
    pady, padx = psize[0] // 2, psize[1] // 2
    outs = []
    for right in rights_warped:
        right_pad = _edge_pad_hw(right, pady, padx)
        for dy in range(psize[0]):
            for dx in range(psize[1]):
                outs.append((left * _shift_slice(right_pad, dy, dx, h, w)).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def aapc_correlation(left: torch.Tensor, right_warped: torch.Tensor,
                     psize: tuple[int, int] = (1, 9)) -> torch.Tensor:
    """StereoAnyVideo's all-in-all-pair correlation: the channels split into
    4 groups; in each, every shift of `left` over a py x px patch times every
    shift of `right_warped` over it (replicate padding), summed over the
    group's channels -> (B,H,W, 4 (py px)^2), ordered by group, then the
    left shift (dy1, dx1), then the right shift (dy2, dx2).

    One batched product over the stacked shifts: (B,H,W,4,P,C/4) times its
    transpose, P = py px, where a loop over the 4 P^2 products would launch
    hundreds of kernels an iteration."""
    b, h, w, c = left.shape
    py, px = psize

    def shifts(x):  # (B,H,W,C) -> (B,H,W,4,P,C/4)
        x_pad = _edge_pad_hw(x, py // 2, px // 2)
        s = torch.stack([_shift_slice(x_pad, dy, dx, h, w) for dy in range(py)
                         for dx in range(px)], dim=-2)
        return s.reshape(b, h, w, py * px, 4, c // 4).transpose(-3, -2)

    out = torch.matmul(shifts(left), shifts(right_warped).transpose(-1, -2))
    return out.reshape(b, h, w, -1)
