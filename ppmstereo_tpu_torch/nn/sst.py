"""SST ("space-super-time") attention block at 1/16 resolution
(counterpart of ppmstereo_tpu/nn/sst.py::SSTBlock): sinusoidal 2-D PE,
a learned time embedding of `num_frames` frames (nearest-interpolated when
the clip length differs) and `depth` rounds of LoFTR self-attention, stereo
cross-attention and temporal attention over both views.

On one rank's frames of a window spread over the seq axis (`shard`), the
self and cross layers are per frame; the time embedding is the whole
window's, sliced at the rank's frames, and the temporal blocks run on the
gathered window (`nn/attention.py::TimeAttnBlock`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ppmstereo_tpu_torch.nn.attention import (
    LocalFeatureTransformer,
    TimeAttnBlock,
    position_encoding_sine,
)

def _interp_nearest_time(embed: torch.Tensor, t: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') along the frame axis of (1, T0, C)."""
    t0 = embed.shape[1]
    if t0 == t:
        return embed
    idx = np.floor(np.arange(t) * t0 / t).astype(np.int64)
    return embed[:, torch.from_numpy(idx).to(embed.device)]


class SSTBlock(nn.Module):
    """The layout named by `attention_type` (the shipped one is
    `self_stereo_temporal_update_time_update_space`): a time embedding where
    it holds "temporal" or "update_time", then per round LoFTR self and
    stereo cross attention ("self_stereo") and temporal attention
    ("temporal"). With neither, the block adds the position encoding only."""

    def __init__(self, dim: int = 256, depth: int = 4, dtype: torch.dtype = torch.float32,
                 num_frames: int = 5, attention_type: str | None = None):
        super().__init__()
        at = attention_type or ""
        self.depth = depth
        self.with_time_embed = "update_time" in at or "temporal" in at
        self.with_temporal = "temporal" in at
        self.with_stereo = "self_stereo" in at
        if self.with_time_embed:
            self.time_embed = nn.Parameter(torch.zeros(1, num_frames, dim))
        for i in range(depth):
            if self.with_temporal:
                self.add_module(f"time_attn_blocks_{i}", TimeAttnBlock(dim, 8, dtype))
            if self.with_stereo:
                self.add_module(f"self_attn_blocks_{i}",
                                LocalFeatureTransformer(dim, 8, ("self",), dtype))
                self.add_module(f"cross_attn_blocks_{i}",
                                LocalFeatureTransformer(dim, 8, ("cross",), dtype))

    def forward(self, f1: torch.Tensor, f2: torch.Tensor, shard=None):
        """f1/f2: (B, T, H, W, C) left/right 1/16 features; under a seq
        `shard` (`parallel/sharding.py::FrameShard`) this rank's frames."""
        b, t, h, w, d = f1.shape
        pe = torch.from_numpy(position_encoding_sine(h, w, d)).to(f1.device, f1.dtype)
        f1 = f1 + pe
        f2 = f2 + pe
        if self.with_time_embed:
            te = _interp_nearest_time(self.time_embed, t if shard is None else shard.total)
            if shard is not None:
                te = shard.local(te)
            te = te.to(f1.dtype)[:, :, None, None, :]
            f1 = f1 + te
            f2 = f2 + te
        if not (self.with_stereo or self.with_temporal):
            return f1, f2
        for i in range(self.depth):
            if self.with_stereo:
                t1 = f1.reshape(b * t, h * w, d)
                t2 = f2.reshape(b * t, h * w, d)
                t1, t2 = getattr(self, f"self_attn_blocks_{i}")(t1, t2)
                t1, t2 = getattr(self, f"cross_attn_blocks_{i}")(t1, t2)
                f1 = t1.reshape(b, t, h, w, d)
                f2 = t2.reshape(b, t, h, w, d)
            if self.with_temporal:
                blk = getattr(self, f"time_attn_blocks_{i}")
                f1 = blk(f1, shard)
                f2 = blk(f2, shard)
        return f1, f2
