"""SST ("space-super-time") attention block at 1/16 resolution
(counterpart of ppmstereo_tpu/nn/sst.py::SSTBlock): sinusoidal 2-D PE,
a learned time embedding of `num_frames` frames (nearest-interpolated when
the clip length differs) and `depth` rounds of LoFTR self-attention, stereo
cross-attention and temporal attention over both views.
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
    """The shipped `self_stereo_temporal_update_time_update_space` layout:
    a time embedding, then per round self, cross and temporal attention."""

    def __init__(self, dim: int = 256, depth: int = 4,
                 dtype: torch.dtype = torch.float32, num_frames: int = 5):
        super().__init__()
        self.depth = depth
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, dim))
        for i in range(depth):
            self.add_module(f"time_attn_blocks_{i}", TimeAttnBlock(dim, 8, dtype))
            self.add_module(f"self_attn_blocks_{i}",
                            LocalFeatureTransformer(dim, 8, ("self",), dtype))
            self.add_module(f"cross_attn_blocks_{i}",
                            LocalFeatureTransformer(dim, 8, ("cross",), dtype))

    def forward(self, f1: torch.Tensor, f2: torch.Tensor):
        """f1/f2: (B, T, H, W, C) left/right 1/16 features."""
        b, t, h, w, d = f1.shape
        pe = torch.from_numpy(position_encoding_sine(h, w, d)).to(f1.device, f1.dtype)
        te = _interp_nearest_time(self.time_embed, t).to(f1.dtype)[:, :, None, None, :]
        f1 = f1 + pe + te
        f2 = f2 + pe + te
        for i in range(self.depth):
            t1 = f1.reshape(b * t, h * w, d)
            t2 = f2.reshape(b * t, h * w, d)
            t1, t2 = getattr(self, f"self_attn_blocks_{i}")(t1, t2)
            t1, t2 = getattr(self, f"cross_attn_blocks_{i}")(t1, t2)
            blk = getattr(self, f"time_attn_blocks_{i}")
            f1 = blk(t1.reshape(b, t, h, w, d))
            f2 = blk(t2.reshape(b, t, h, w, d))
        return f1, f2
