"""RAFT-style feature encoders, channels-last (counterpart of
ppmstereo_tpu/nn/encoder.py::ResidualBlock, BasicEncoder, BasicEncoderVFM,
MultiLevelEncoderVFM, ResNetFPN, MultiLevelResNetFPN).

BasicEncoder: a 7x7 stride-2 stem and three residual stages -> 1/4
resolution, `output_dim` channels, instance norm. BasicEncoderVFM
concatenates a foundation model's features before the output conv.
MultiLevelEncoderVFM (PPMStereo-VDA) fuses the VDA fusion pyramid into
1/16, 1/8 and 1/4 maps top-down. ResNetFPN and MultiLevelResNetFPN, which
no model calls, run four residual stages to 1/16 and fuse them top-down
through 1x1 laterals. Left and right frames are folded into the batch axis
by the caller.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.norm import GroupNorm, InstanceNorm
from ppmstereo_tpu_torch.ops.geometry import upsample2x_nearest

NORM_FNS = ("instance", "group", "none")


def add_norms(module: nn.Module, norm_fn: str, features: int, count: int,
              num_groups: int = 8) -> list:
    """The `count` norms of `module` in call order, registered under flax's
    names: one parameterless InstanceNorm (`norm`), `GroupNorm_<i>` of
    `num_groups` groups, or none."""
    if norm_fn == "instance":
        module.norm = InstanceNorm()
        return [module.norm] * count
    if norm_fn == "group":
        for i in range(count):
            module.add_module(f"GroupNorm_{i}", GroupNorm(num_groups, features))
        return [getattr(module, f"GroupNorm_{i}") for i in range(count)]
    if norm_fn == "none":
        return [nn.Identity()] * count
    raise ValueError(f"norm_fn {norm_fn!r}: one of {NORM_FNS}")


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm_fn: str = "instance"):
        super().__init__()
        self.Conv_0 = Conv(in_planes, planes, (3, 3), stride=stride, dtype=dtype)
        self.Conv_1 = Conv(planes, planes, (3, 3), dtype=dtype)
        # the reference always applies the 1x1 projection
        self.Conv_2 = Conv(in_planes, planes, (1, 1), stride=stride,
                           padding=(0, 0), dtype=dtype)
        self.norms = add_norms(self, norm_fn, planes, 3, planes // 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n0, n1, n2 = self.norms
        y = F.relu(n0(self.Conv_0(x)))
        y = F.relu(n1(self.Conv_1(y)))
        x = n2(self.Conv_2(x))
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


class ResNetFPN(nn.Module):
    """ResNet-style FPN encoder: a 7x7 stride-2 stem, residual stages of
    64, 128, 256 and 512 planes (1/2 to 1/16), then the 1/16, 1/8 and 1/4
    maps fused top-down through 1x1 laterals (`lat5`, `lat4`, `lat3`) and
    2x nearest upsampling; a 3x3 conv gives the 1/4 output."""

    STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(3, 64, (7, 7), stride=2, dtype=dtype)
        self.stem_norms = add_norms(self, norm_fn, 64, 1)
        planes_in = 64
        for i, (planes, stride) in enumerate(self.STAGES):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(planes_in, planes, stride, dtype, norm_fn))
            planes_in = planes
        for name, planes in (("lat5", 512), ("lat4", 256), ("lat3", 128)):
            self.add_module(name, Conv(planes, output_dim, (1, 1), padding=(0, 0), dtype=dtype))
        self._add_outputs(output_dim, dtype)

    def _add_outputs(self, output_dim: int, dtype: torch.dtype) -> None:
        self.Conv_1 = Conv(output_dim, output_dim, (3, 3), dtype=dtype)

    def pyramid(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The fused maps (p3, p4, p5) at 1/4, 1/8 and 1/16."""
        x = F.relu(self.stem_norms[0](self.Conv_0(x)))
        c = []
        for i in range(len(self.STAGES)):
            x = getattr(self, f"ResidualBlock_{i}")(x)
            c.append(x)
        _, c3, c4, c5 = c
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + upsample2x_nearest(p5)
        p3 = self.lat3(c3) + upsample2x_nearest(p4)
        return p3, p4, p5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(self.pyramid(x)[0])


class MultiLevelResNetFPN(ResNetFPN):
    """ResNetFPN with a 3x3 output conv at each of 1/4, 1/8 and 1/16
    (`out4`, `out8`, `out16`): returns the three maps, finest first."""

    def _add_outputs(self, output_dim: int, dtype: torch.dtype) -> None:
        for name in ("out4", "out8", "out16"):
            self.add_module(name, Conv(output_dim, output_dim, (3, 3), dtype=dtype))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        p3, p4, p5 = self.pyramid(x)
        return self.out4(p3), self.out8(p4), self.out16(p5)
