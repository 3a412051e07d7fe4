"""AnimateDiff-style temporal motion module (counterpart of
ppmstereo_tpu/nn/vda/motion.py): GroupNorm, proj_in, a transformer block of
per-pixel self-attention over the frames (sinusoidal position encoding) and
a GEGLU feed-forward, a zero-initialised proj_out, and the residual. Videos
are (B, T, H, W, C)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Linear
from ppmstereo_tpu_torch.nn.norm import GroupNorm, LayerNorm


def _sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class TemporalAttention(nn.Module):
    """Self-attention over the frame axis of (N_pixels, T, C) tokens; f32
    logits and softmax."""

    def __init__(self, dim: int, num_heads: int = 8, temporal_max_len: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.temporal_max_len = temporal_max_len
        self.to_q = Linear(dim, dim, use_bias=False, dtype=dtype)
        self.to_k = Linear(dim, dim, use_bias=False, dtype=dtype)
        self.to_v = Linear(dim, dim, use_bias=False, dtype=dtype)
        self.to_out = Linear(dim, dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        n, t, c = tokens.shape
        pe = torch.from_numpy(_sinusoidal_pe(self.temporal_max_len, c)[:t])
        tokens = tokens + pe.to(tokens.device, tokens.dtype)
        dh = c // self.num_heads

        def heads(x):
            return x.reshape(n, t, self.num_heads, dh).transpose(1, 2)

        q, k, v = heads(self.to_q(tokens)), heads(self.to_k(tokens)), heads(self.to_v(tokens))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits * dh**-0.5, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(n, t, c)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        self.Dense_0 = Linear(dim, 2 * inner, dtype=dtype)
        self.Dense_1 = Linear(inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.Dense_0(x).chunk(2, dim=-1)
        return self.Dense_1(a * F.gelu(g))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, num_attention_blocks: int = 2,
                 temporal_max_len: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_attention_blocks = num_attention_blocks
        for i in range(num_attention_blocks):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim, 1e-5))
            self.add_module(f"attn_{i}", TemporalAttention(dim, num_heads, temporal_max_len,
                                                           dtype))
        self.add_module(f"LayerNorm_{num_attention_blocks}", LayerNorm(dim, 1e-5))
        self.GEGLUFeedForward_0 = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_attention_blocks):
            y = getattr(self, f"LayerNorm_{i}")(tokens)
            tokens = tokens + getattr(self, f"attn_{i}")(y)
        y = getattr(self, f"LayerNorm_{self.num_attention_blocks}")(tokens)
        return tokens + self.GEGLUFeedForward_0(y)


class TemporalModule(nn.Module):
    """x (B, T, H, W, C) -> the same, with temporal attention mixed in."""

    def __init__(self, in_channels: int, num_heads: int = 8, num_transformer_block: int = 1,
                 num_attention_blocks: int = 2, temporal_max_len: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = in_channels
        self.num_transformer_block = num_transformer_block
        self.GroupNorm_0 = GroupNorm(32, c, 1e-6)
        self.proj_in = Linear(c, c, dtype=dtype)
        for i in range(num_transformer_block):
            self.add_module(f"block_{i}", TemporalTransformerBlock(
                c, num_heads, num_attention_blocks, temporal_max_len, dtype))
        self.proj_out = Linear(c, c, dtype=dtype)
        with torch.no_grad():
            self.proj_out.weight.zero_()
            self.proj_out.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = self.proj_in(self.GroupNorm_0(x))
        tokens = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        for i in range(self.num_transformer_block):
            tokens = getattr(self, f"block_{i}")(tokens)
        y = tokens.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        return x + self.proj_out(y)
