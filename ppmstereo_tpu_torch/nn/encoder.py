"""RAFT-style feature encoders, channels-last (counterpart of
ppmstereo_tpu/nn/encoder.py::ResidualBlock, BasicEncoder, BasicEncoderVFM,
MultiLevelEncoderVFM).

BasicEncoder: a 7x7 stride-2 stem and three residual stages -> 1/4
resolution, `output_dim` channels, instance norm. BasicEncoderVFM
concatenates a foundation model's features before the output conv.
MultiLevelEncoderVFM (PPMStereo-VDA) fuses the VDA fusion pyramid into
1/16, 1/8 and 1/4 maps top-down. Left and right frames are folded into the
batch axis by the caller.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.norm import InstanceNorm
from ppmstereo_tpu_torch.ops.geometry import upsample2x_nearest


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_planes, planes, (3, 3), stride=stride, dtype=dtype)
        self.Conv_1 = Conv(planes, planes, (3, 3), dtype=dtype)
        # the reference always applies the 1x1 projection
        self.Conv_2 = Conv(in_planes, planes, (1, 1), stride=stride,
                           padding=(0, 0), dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm(self.Conv_0(x)))
        y = F.relu(self.norm(self.Conv_1(y)))
        x = self.norm(self.Conv_2(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(3, 64, (7, 7), stride=2, dtype=dtype)
        self.norm = InstanceNorm()
        planes_in = 64
        for i, (planes, stride) in enumerate(((64, 1), (96, 2), (128, 1))):
            self.add_module(f"ResidualBlock_{2 * i}",
                            ResidualBlock(planes_in, planes, stride, dtype))
            self.add_module(f"ResidualBlock_{2 * i + 1}",
                            ResidualBlock(planes, planes, 1, dtype))
            planes_in = planes
        self.Conv_1 = Conv(128, output_dim, (1, 1), padding=(0, 0), dtype=dtype)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The stem and the residual stages: (..., H/4, W/4, 128)."""
        x = F.relu(self.norm(self.Conv_0(x)))
        for i in range(6):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(self.trunk(x))


class BasicEncoderVFM(BasicEncoder):
    """BasicEncoder with `vfm_dim` channels of foundation-model features,
    given at its 1/4 grid, concatenated before the output conv."""

    def __init__(self, output_dim: int = 256, vfm_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__(output_dim, dtype)
        self.Conv_1 = Conv(128 + vfm_dim, output_dim, (1, 1), padding=(0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor, vfm_features: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(torch.cat([self.trunk(x), vfm_features], dim=-1))


class _UpFuse(nn.Module):
    """2x nearest upsample, 3x3 conv, instance norm, relu."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, out_dim, (3, 3), dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.Conv_0(upsample2x_nearest(x))))


class _DecodeVFM(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, out_dim, (3, 3), dtype=dtype)
        self.Conv_1 = Conv(out_dim, out_dim, (3, 3), dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.norm(self.Conv_0(x))))


class MultiLevelEncoderVFM(nn.Module):
    """The 3-scale encoder of PPMStereo-VDA: a stride-1 stem and five
    residual stages (strides 1, 2, 2, 2, 2) give 1/4, 1/8 and 1/16 maps,
    each fused with the VFM pyramid's map of its scale and the coarser
    result upsampled.

    vfm_features: 4 maps (finest first) already resized by the caller to 1/4,
    1/8, 1/16 and 1/32 of the input, `vfm_dim` channels each. Returns (f4,
    f8, f16), `output_dim` channels each."""

    def __init__(self, output_dim: int = 256, vfm_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = output_dim
        self.Conv_0 = Conv(3, 64, (7, 7), stride=1, dtype=dtype)
        self.norm = InstanceNorm()
        planes_in = 64
        stages = ((64, 1), (96, 2), (128, 2), (128, 2), (128, 2))
        for i, (planes, stride) in enumerate(stages):
            self.add_module(f"ResidualBlock_{2 * i}",
                            ResidualBlock(planes_in, planes, stride, dtype))
            self.add_module(f"ResidualBlock_{2 * i + 1}",
                            ResidualBlock(planes, planes, 1, dtype))
            planes_in = planes
        self.upconv_16 = _UpFuse(vfm_dim, 64, dtype)
        self.decode_16x = _DecodeVFM(128 + vfm_dim + 64, d, dtype)
        self.upconv_8 = _UpFuse(d, 128, dtype)
        self.decode_8x = _DecodeVFM(128 + vfm_dim + 128, d, dtype)
        self.upconv_4 = _UpFuse(d, 128, dtype)
        self.decode_4x = _DecodeVFM(128 + vfm_dim + 128, d, dtype)

    def forward(self, x: torch.Tensor, vfm_features) -> tuple[torch.Tensor, ...]:
        x = F.relu(self.norm(self.Conv_0(x)))
        scales = []
        for i in range(10):
            x = getattr(self, f"ResidualBlock_{i}")(x)
            if i in (5, 7, 9):  # the 1/4, 1/8 and 1/16 stages' outputs
                scales.append(x)
        x4, x8, x16 = scales
        v4, v8, v16, v32 = vfm_features
        f16 = self.decode_16x(torch.cat([x16, v16, self.upconv_16(v32)], dim=-1))
        f8 = self.decode_8x(torch.cat([x8, v8, self.upconv_8(f16)], dim=-1))
        f4 = self.decode_4x(torch.cat([x4, v4, self.upconv_4(f8)], dim=-1))
        return f4, f8, f16
