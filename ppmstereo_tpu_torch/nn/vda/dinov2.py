"""DINOv2 ViT encoder on channels-last tokens (counterpart of
ppmstereo_tpu/nn/vda/dinov2.py).

Patch-14 embedding, a learned position embedding interpolated bicubically
(torch-exact, with DINOv2's 0.1 scale-factor offset) to any patch grid,
pre-norm blocks with LayerScale and an exact-GELU MLP. Only what the VDA
head reads is exposed: `get_intermediate_layers`, the final norm applied to
each requested layer, as (patch tokens, class token).

The attention is a plain product, softmax and product: the logits
accumulate in f32 and the softmax runs in f32, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import ConvND, Linear
from ppmstereo_tpu_torch.nn.norm import LayerNorm

_CONFIGS = {
    # name: (embed_dim, depth, num_heads)
    "vits": (384, 12, 6),
    "vitb": (768, 12, 12),
    "vitl": (1024, 24, 16),
}
PATCH = 14
POS_GRID = 37  # 518 / 14, the DINOv2 pretraining grid


def _torch_bicubic_weights(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """Row-stochastic (n_out, n_in) matrix of torch's F.interpolate(mode=
    'bicubic', align_corners=False, scale_factor=scale, antialias=False):
    src = (dst + 0.5) / scale - 0.5, cubic convolution kernel A = -0.75,
    border-clamped taps."""
    a = -0.75

    def kernel(x):
        x = np.abs(x)
        return np.where(
            x <= 1,
            ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
        )

    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, n_in - 1)
        np.add.at(w, (np.arange(n_out), idx), kernel(frac - tap))
    return w.astype(np.float32)


def interpolate_pos_embed(patch_pe: torch.Tensor, ph: int, pw: int, grid: int,
                          offset: float = 0.1) -> torch.Tensor:
    """DINOv2's position-embedding interpolation: bicubic with the 0.1
    scale-factor offset, no antialias. (1, grid, grid, dim) -> (1, ph, pw,
    dim), f32."""
    wy = torch.from_numpy(_torch_bicubic_weights(grid, ph, (ph + offset) / grid))
    wx = torch.from_numpy(_torch_bicubic_weights(grid, pw, (pw + offset) / grid))
    out = torch.einsum("oi,bijd->bojd", wy.to(patch_pe.device), patch_pe.float())
    return torch.einsum("oj,bijd->biod", wx.to(patch_pe.device), out)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        dh = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, heads, N, dh)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits * dh**-0.5, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hid = int(dim * mlp_ratio)
        self.LayerNorm_0 = LayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.LayerNorm_1 = LayerNorm(dim, 1e-6)
        self.Dense_0 = Linear(dim, hid, dtype=dtype)
        self.Dense_1 = Linear(hid, dim, dtype=dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.LayerNorm_0(x)))
        y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + self.ls2(y)


class DINOv2(nn.Module):
    """Input (N, H, W, 3) with H and W multiples of 14."""

    def __init__(self, model_name: str = "vits", dtype: torch.dtype = torch.float32):
        super().__init__()
        dim, depth, heads = _CONFIGS[model_name]
        self.depth = depth
        self.patch_embed = ConvND(3, dim, (PATCH, PATCH), stride=PATCH, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID * POS_GRID + 1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", Block(dim, heads, dtype=dtype))
        self.norm = LayerNorm(dim, 1e-6)

    def get_intermediate_layers(self, x: torch.Tensor, layer_idx: tuple
                                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(patch tokens (N, ph*pw, dim), class token (N, dim))] of each
        requested block, after the final norm (the reference's norm=True)."""
        n, h, w, _ = x.shape
        ph, pw = h // PATCH, w // PATCH
        tokens = self.patch_embed(x)
        dim = tokens.shape[-1]
        tokens = tokens.reshape(n, ph * pw, dim)
        g = POS_GRID
        cls_pe = self.pos_embed[:, :1]
        patch_pe = self.pos_embed[:, 1:].reshape(1, g, g, dim)
        # the reference skips the interpolation at the square pretraining grid only
        if (ph, pw) != (g, g):
            patch_pe = interpolate_pos_embed(patch_pe, ph, pw, g)
        tokens = tokens + patch_pe.reshape(1, ph * pw, dim).to(tokens.dtype)
        cls = (self.cls_token + cls_pe).to(tokens.dtype).expand(n, 1, dim)
        x = torch.cat([cls, tokens], dim=1)
        outs, want = [], set(layer_idx)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if i in want:
                y = self.norm(x)
                outs.append((y[:, 1:], y[:, 0]))
        return outs


def intermediate_layer_idx(model_name: str) -> tuple:
    return {"vits": (2, 5, 8, 11), "vitl": (4, 11, 17, 23)}[model_name]


def embed_dim(model_name: str) -> int:
    return _CONFIGS[model_name][0]
