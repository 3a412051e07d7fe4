"""The separable 3-D conv GRU of PPMStereo on (B, T, H, W, C)
(counterpart of ppmstereo_tpu/nn/gru.py::_SKConv, SKSepConvGRU3D): three
gated passes over width (large-kernel 1x1x15 -> 1x1x5), height (1x5x1) and
time (5x1x1)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv


def _gate(h, x, convz, convr, convq):
    hx = torch.cat([h, x], dim=-1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    q = torch.tanh(convq(torch.cat([r * h, x], dim=-1)))
    return (1 - z) * h + z * q


class _SKConv(nn.Module):
    """Large kernel -> GELU -> small kernel, for the z/r gates."""

    def __init__(self, in_features: int, features: int, big: tuple, small: tuple,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, big, dtype=dtype)
        self.Conv_1 = Conv(features, features, small, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.gelu(self.Conv_0(x)))


class SKSepConvGRU3D(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, cin = hidden_dim, hidden_dim + input_dim
        self._SKConv_0 = _SKConv(cin, d, (1, 1, 15), (1, 1, 5), dtype)
        self._SKConv_1 = _SKConv(cin, d, (1, 1, 15), (1, 1, 5), dtype)
        self.Conv_0 = Conv(cin, d, (1, 1, 5), dtype=dtype)
        for i in range(1, 4):
            self.add_module(f"Conv_{i}", Conv(cin, d, (1, 5, 1), dtype=dtype))
        for i in range(4, 7):
            self.add_module(f"Conv_{i}", Conv(cin, d, (5, 1, 1), dtype=dtype))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = _gate(h, x, self._SKConv_0, self._SKConv_1, self.Conv_0)   # width
        h = _gate(h, x, self.Conv_1, self.Conv_2, self.Conv_3)         # height
        return _gate(h, x, self.Conv_4, self.Conv_5, self.Conv_6)      # time
