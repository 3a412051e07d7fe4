"""Sinusoidal encodings, LoFTR linear and full attention, the time/space
attention blocks on (B, T, H, W, C) videos, and the transformer `Mlp` and
decomposed relative position bias `RelPosEmb` that no model calls
(counterpart of ppmstereo_tpu/nn/attention.py). Products that the JAX
package accumulates in f32 are taken in f32 here too; the rest run in the
module dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Dense, Linear
from ppmstereo_tpu_torch.nn.norm import LayerNorm


def position_encoding_sine(h: int, w: int, d_model: int) -> np.ndarray:
    """2-D sinusoidal PE, (H, W, C), LoFTR temp_bug_fix variant: 1-based
    positions, channels interleaved [sin x, cos x, sin y, cos y]."""
    pe = np.zeros((h, w, d_model), dtype=np.float32)
    y_pos = np.arange(1, h + 1, dtype=np.float32)[:, None, None]
    x_pos = np.arange(1, w + 1, dtype=np.float32)[None, :, None]
    div = np.exp(
        np.arange(0, d_model // 2, 2, dtype=np.float32)
        * (-math.log(10000.0) / (d_model // 2))
    )[None, None, :]
    pe[:, :, 0::4] = np.sin(x_pos * div)
    pe[:, :, 1::4] = np.cos(x_pos * div)
    pe[:, :, 2::4] = np.sin(y_pos * div)
    pe[:, :, 3::4] = np.cos(y_pos * div)
    return pe


def temporal_positional_encoding(t: int, channels: int, normalize: bool = True,
                                 scale: float = 1.0) -> np.ndarray:
    """Sinusoidal temporal PE, (T, C)."""
    pos = np.arange(t, dtype=np.float32)
    if normalize:
        pos = pos / max(t - 1, 1) * scale
    div = 1.0 / (10000.0 ** (np.arange(0, channels, 2, dtype=np.float32) / channels))
    ang = pos[:, None] * div[None, :]
    pe = np.zeros((t, channels), dtype=np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def linear_attention(q, k, v, eps: float = 1e-6):
    """'Transformers are RNNs' linear attention, elu + 1 feature map.

    q: (N, L, H, D), k/v: (N, S, H, D) -> (N, L, H, D)."""
    q = F.elu(q) + 1
    k = F.elu(k) + 1
    v_length = v.shape[1]
    v = v / v_length
    kv = torch.einsum("nshd,nshv->nhdv", k.float(), v.float())
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q.float(), k.sum(dim=1).float()) + eps)
    out = torch.einsum("nlhd,nhdv->nlhv", q, kv.to(q.dtype)) * z.to(q.dtype)[..., None]
    return out * v_length


def full_attention(q, k, v):
    """Softmax attention over (N, L, H, D) tokens: f32 logits, the softmax
    over the key axis, the probabilities cast to v's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.einsum("nlhd,nshd->nlsh", q.float(), k.float())
    probs = torch.softmax(scale * logits, dim=2).to(v.dtype)
    return torch.einsum("nlsh,nshd->nlhd", probs, v)


ATTENTIONS = {"linear": linear_attention, "full": full_attention}


class LoFTREncoderLayer(nn.Module):
    """Projections, linear (default) or full attention, merge and an MLP
    residual."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32,
                 attention: str = "linear"):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"attention {attention!r}: one of {sorted(ATTENTIONS)}")
        self.nhead = nhead
        self.attention = ATTENTIONS[attention]
        self.q_proj = Linear(d_model, d_model, use_bias=False, dtype=dtype)
        self.k_proj = Linear(d_model, d_model, use_bias=False, dtype=dtype)
        self.v_proj = Linear(d_model, d_model, use_bias=False, dtype=dtype)
        self.merge = Linear(d_model, d_model, use_bias=False, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(d_model, 1e-5)
        self.Dense_0 = Linear(2 * d_model, 2 * d_model, use_bias=False, dtype=dtype)
        self.Dense_1 = Linear(2 * d_model, d_model, use_bias=False, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d_model, 1e-5)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        n, _, d = x.shape
        heads = (n, -1, self.nhead, d // self.nhead)
        q = self.q_proj(x).reshape(heads)
        k = self.k_proj(source).reshape(heads)
        v = self.v_proj(source).reshape(heads)
        message = self.attention(q, k, v).reshape(n, -1, d)
        message = self.LayerNorm_0(self.merge(message))
        message = self.Dense_0(torch.cat([x, message], dim=-1))
        message = self.LayerNorm_1(self.Dense_1(F.relu(message)))
        return x + message


class LocalFeatureTransformer(nn.Module):
    """Self or cross LoFTR layers over two token sets, with linear
    (default) or full attention."""

    def __init__(self, d_model: int, nhead: int, layer_names: tuple,
                 dtype: torch.dtype = torch.float32, attention: str = "linear"):
        super().__init__()
        self.layer_names = tuple(layer_names)
        for i, _ in enumerate(self.layer_names):
            self.add_module(f"layer_{i}", LoFTREncoderLayer(d_model, nhead, dtype, attention))

    def forward(self, feat0, feat1):
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer_{i}")
            if name == "self":
                feat0 = layer(feat0, feat0)
                feat1 = layer(feat1, feat1)
            elif name == "cross":
                # sequential: feat1 attends to the already-updated feat0
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
            else:
                raise KeyError(name)
        return feat0, feat1


def _degenerate_attention(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Softmax attention with q = k = v = x split into heads (no
    projections): (B, N, C) -> (B, N, C)."""
    b, n, c = x.shape
    dh = c // num_heads
    q = x.reshape(b, n, num_heads, dh).transpose(1, 2)
    logits = torch.matmul(q.float(), q.float().transpose(-1, -2))
    probs = torch.softmax(logits * (dh**-0.5), dim=-1).to(x.dtype)
    out = torch.matmul(probs, q)
    return out.transpose(1, 2).reshape(b, n, c)


class TimeAttnBlock(nn.Module):
    """Per-pixel temporal attention with a zero-initialised output
    projection. Input (B, T, H, W, C)."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.LayerNorm_0 = LayerNorm(dim, 1e-5)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.temporal_fc = Linear(dim, dim, dtype=dtype)
        with torch.no_grad():
            self.temporal_fc.weight.zero_()
            self.temporal_fc.bias.zero_()

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """shard: this rank's frames of a window over the seq axis
        (`parallel/sharding.py::FrameShard`; None: the whole window). Every
        frame attends over all the window's frames, so the block runs on the
        gathered window and keeps this rank's frames (small at 1/16)."""
        if shard is not None:
            return shard.local(self(shard.gather(x)))
        b, t, h, w, c = x.shape
        tokens = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        y = _degenerate_attention(self.LayerNorm_0(tokens), self.num_heads)
        y = self.temporal_fc(self.proj(y))
        y = y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        return x + y


class SpaceAttnBlock(nn.Module):
    """Per-frame spatial LoFTR self-attention."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.LoFTREncoderLayer_0 = LoFTREncoderLayer(dim, num_heads, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        tokens = x.reshape(b * t, h * w, c)
        return self.LoFTREncoderLayer_0(tokens, tokens).reshape(b, t, h, w, c)


class Mlp(nn.Module):
    """Transformer MLP: fc1, exact GELU, fc2 (hidden and output widths
    default to the input's)."""

    def __init__(self, in_features: int, hidden_features: int | None = None,
                 out_features: int | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        hid = hidden_features or in_features
        self.fc1 = Dense(in_features, hid, dtype=dtype)
        self.fc2 = Dense(hid, out_features or in_features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class RelPosEmb(nn.Module):
    """Decomposed 2-D relative position bias: q (B, heads, H, W, d) ->
    scores (B, heads, H, W, H, W), the sum of a height and a width term from
    the embeddings `rel_height` / `rel_width`, (2 max_pos_size - 1, d),
    drawn N(0, 1) as torch's nn.Embedding is."""

    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        self.max_pos_size = max_pos_size
        n = 2 * max_pos_size - 1
        self.rel_height = nn.Parameter(torch.randn(n, dim_head))
        self.rel_width = nn.Parameter(torch.randn(n, dim_head))

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        _, _, h, w, d = q.shape
        pos = torch.arange(self.max_pos_size, device=q.device)
        rel_ind = pos[None, :] - pos[:, None] + self.max_pos_size - 1
        height_emb = self.rel_height[rel_ind[:h, :h].reshape(-1)].reshape(h, h, 1, d)
        width_emb = self.rel_width[rel_ind[:w, :w].reshape(-1)].reshape(w, 1, w, d)
        dtype = torch.promote_types(q.dtype, height_emb.dtype)  # jnp.einsum's promotion
        q = q.to(dtype)
        height_score = torch.einsum("bhxyd,xuvd->bhxyuv", q, height_emb.to(dtype))
        width_score = torch.einsum("bhxyd,yuvd->bhxyuv", q, width_emb.to(dtype))
        return height_score + width_score
