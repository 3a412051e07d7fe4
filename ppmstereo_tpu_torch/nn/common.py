"""Convolutions and dense layers on channels-last tensors, with an explicit
compute dtype.

Counterpart of ppmstereo_tpu/nn/common.py. Every layer computes in its
`dtype` (bf16 under the mixed-precision policy): input, weight and bias are
cast to it, as flax does with `dtype=` and f32 parameters. Inputs are
(..., H, W, C) for 2-D and (..., T, H, W, C) for 3-D layers; leading axes
fold into the batch. The permuted view handed to cuDNN is NHWC / NDHWC in
memory (torch's channels_last formats), so no copy is made for the layout.

Parameter names follow the flax paths: `ConvND` and `Linear` hold `weight`
and `bias` themselves (flax `nn.Conv` / `nn.Dense`), while `Conv` and
`Dense` wrap one of them as the child `Conv_0` / `Dense_0`, as the JAX
package's wrappers do.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _as_tuple(v, n: int) -> tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


class ConvND(nn.Module):
    """2-D or 3-D convolution over channels-last input (flax `nn.Conv`)."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 stride: Sequence[int] | int = 1,
                 padding: Sequence[int] | int = 0, use_bias: bool = True,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nd = len(kernel)
        if self.nd not in (2, 3):
            raise ValueError(f"ConvND takes 2-D or 3-D kernels, got {kernel}")
        self.stride = _as_tuple(stride, self.nd)
        self.padding = _as_tuple(padding, self.nd)
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, *kernel)
        )
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        bound = 1.0 / math.sqrt((in_features // groups) * math.prod(kernel))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor, padding: tuple | None = None) -> torch.Tensor:
        """padding: this call's, in place of the layer's."""
        lead = x.shape[: x.dim() - self.nd - 1]
        x = x.reshape(-1, *x.shape[x.dim() - self.nd - 1:]).movedim(-1, 1)
        conv = F.conv2d if self.nd == 2 else F.conv3d
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = conv(x.to(self.dtype), self.weight.to(self.dtype), bias,
                 self.stride, self.padding if padding is None else padding, 1, self.groups)
        y = y.movedim(1, -1)
        return y.reshape(*lead, *y.shape[1:])


class Conv(nn.Module):
    """Convolution with torch-style symmetric padding (k // 2 per spatial
    axis by default); the JAX package's `Conv` wrapper."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 stride: Sequence[int] | int = 1,
                 padding: Sequence[int] | None = None, use_bias: bool = True,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = tuple(padding) if padding is not None else tuple(k // 2 for k in kernel)
        self.Conv_0 = ConvND(in_features, features, kernel, stride, pad,
                             use_bias, groups, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)

    def on_halo(self, x: torch.Tensor) -> torch.Tensor:
        """The 3-D convolution of a frame block already extended by its time
        halo (`parallel/sharding.py::FrameShard.halo`): no padding in time,
        so the output has the block's frames."""
        conv = self.Conv_0
        return conv(x, padding=(0, *conv.padding[1:]))

    def time_sharded(self, x: torch.Tensor, shard) -> torch.Tensor:
        """The 3-D convolution of this rank's frames of a window whose frames
        spread over the seq axis (`shard`, or None for the whole window): the
        block extended by the time padding's worth of the neighbours' frames
        (zero frames past the clip's ends, the layer's zero padding), then
        convolved with no time padding. Each output frame sums the terms of
        the unsharded convolution."""
        if shard is None:
            return self(x)
        return self.on_halo(shard.halo(x, self.Conv_0.padding[0]))


class Linear(nn.Module):
    """Dense layer over the last axis (flax `nn.Dense`)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Dense(nn.Module):
    """The JAX package's `Dense` wrapper: one `Linear` named `Dense_0`."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Linear(in_features, features, use_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)
