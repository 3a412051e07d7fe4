"""Separable conv GRUs on channels-last tensors (counterpart of
ppmstereo_tpu/nn/gru.py).

The 3-D GRUs run over (B, T, H, W, C): PPMStereo's SKSepConvGRU3D makes
three gated passes over width (large-kernel 1x1x15 -> 1x1x5), height (1x5x1)
and time (5x1x1); DynamicStereo's SepConvGRU3D makes the same three passes
with 5-tap kernels. The 2-D GRUs run over (B, H, W, C): RAFT's SepConvGRU
(horizontal then vertical), ConvGRU (one 3x3 pass) and SKSepConvGRU.

Each gate conv reads cat[h, x] (hidden_dim + input_dim channels); its name is
the flax path's (`Conv_i` in creation order, `_SKConv_i`).
"""

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


class _PassGRU(nn.Module):
    """Gated passes with one kernel shape each: three convs (z, r, q) per
    pass, `Conv_0` .. `Conv_{3n-1}` in pass order."""

    KERNELS: tuple = ()

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, k in enumerate(self.KERNELS):
            for j in range(3):
                self.add_module(f"Conv_{3 * i + j}", Conv(cin, hidden_dim, k, dtype=dtype))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.KERNELS)):
            h = _gate(h, x, *(getattr(self, f"Conv_{3 * i + j}") for j in range(3)))
        return h


class SepConvGRU(_PassGRU):
    """2-D separable GRU: a horizontal (1, 5) then a vertical (5, 1) pass."""

    KERNELS = ((1, 5), (5, 1))


class ConvGRU(_PassGRU):
    """2-D GRU: one 3x3 pass."""

    KERNELS = ((3, 3),)


class SepConvGRU3D(_PassGRU):
    """Plain 3-D separable GRU (DynamicStereo's): width (1, 1, 5), height
    (1, 5, 1), then time (5, 1, 1)."""

    KERNELS = ((1, 1, 5), (1, 5, 1), (5, 1, 1))


class SKSepConvGRU(nn.Module):
    """2-D GRU with large-kernel z/r gates on the horizontal pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, cin = hidden_dim, hidden_dim + input_dim
        self._SKConv_0 = _SKConv(cin, d, (1, 15), (1, 5), dtype)
        self._SKConv_1 = _SKConv(cin, d, (1, 15), (1, 5), dtype)
        self.Conv_0 = Conv(cin, d, (1, 5), dtype=dtype)
        for i in range(1, 4):
            self.add_module(f"Conv_{i}", Conv(cin, d, (5, 1), dtype=dtype))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = _gate(h, x, self._SKConv_0, self._SKConv_1, self.Conv_0)  # horizontal
        return _gate(h, x, self.Conv_1, self.Conv_2, self.Conv_3)      # vertical


class SKSepConvGRU3D(nn.Module):
    """PPMStereo's recurrence: a large-kernel width pass, then height, then
    time."""

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
