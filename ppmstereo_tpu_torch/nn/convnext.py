"""ConvNeXt-V2 backbone and the PPMStereo context network ("cnet"),
channels-last (counterpart of ppmstereo_tpu/nn/convnext.py).

LayerNorm, GRN and the pointwise layers act on the trailing channel axis.
Inference only: the frozen backbone needs no gradient handling here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv, ConvND, Linear
from ppmstereo_tpu_torch.nn.norm import InstanceNorm, LayerNorm
from ppmstereo_tpu_torch.ops.geometry import upsample2x_nearest

# ConvNeXt-V2 "tiny", the context net of the shipped config
_DEPTHS = (3, 3, 9, 3)
_DIMS = (96, 192, 384, 768)


class GRN(nn.Module):
    """Global Response Normalisation, in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        gx = torch.sqrt(torch.sum(x32 * x32, dim=(-3, -2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x32 * nx) + self.beta + x32).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv(dim, dim, (7, 7), groups=dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dim, 1e-6)
        self.Dense_0 = Linear(dim, 4 * dim, dtype=dtype)
        self.GRN_0 = GRN(4 * dim)
        self.Dense_1 = Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(self.dwconv(x))
        y = self.GRN_0(F.gelu(self.Dense_0(y)))
        return x + self.Dense_1(y)


class ConvNeXtV2(nn.Module):
    """Four stages returning the (x4, x8, x16, x32) pyramid."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        depths, dims = _DEPTHS, _DIMS
        self.Conv_0 = ConvND(3, dims[0], (4, 4), stride=4, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dims[0], 1e-6)
        for i in range(1, 4):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dims[i - 1], 1e-6))
            self.add_module(f"Conv_{i}", ConvND(dims[i - 1], dims[i], (2, 2),
                                                stride=2, dtype=dtype))
        n = 0
        for i in range(4):
            for _ in range(depths[i]):
                self.add_module(f"ConvNeXtBlock_{n}", ConvNeXtBlock(dims[i], dtype))
                n += 1

    def forward(self, x: torch.Tensor):
        feats = []
        n = 0
        for i in range(4):
            if i == 0:
                x = self.LayerNorm_0(self.Conv_0(x))
            else:
                x = getattr(self, f"Conv_{i}")(getattr(self, f"LayerNorm_{i}")(x))
            for _ in range(_DEPTHS[i]):
                x = getattr(self, f"ConvNeXtBlock_{n}")(x)
                n += 1
            feats.append(x)
        return tuple(feats)


class _UpConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, out_dim, (3, 3), dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.Conv_0(upsample2x_nearest(x))))


class _Decode(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, out_dim, (1, 1), padding=(0, 0), dtype=dtype)
        self.Conv_1 = Conv(out_dim, out_dim, (3, 3), dtype=dtype)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.norm(self.Conv_0(x))))


class ContextNet(nn.Module):
    """ConvNeXt-V2 and top-down decoders -> (x4, x8, x16), each
    `output_dim` channels."""

    def __init__(self, output_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = _DIMS
        d = output_dim
        self.convnext = ConvNeXtV2(dtype)
        self.upconv_16 = _UpConv(dims[3], d, dtype)
        self.decode_16x = _Decode(dims[2] + d, d, dtype)
        self.upconv_8 = _UpConv(d, d, dtype)
        self.decode_8x = _Decode(dims[1] + d, d, dtype)
        self.upconv_4 = _UpConv(d, d, dtype)
        self.decode_4x = _Decode(dims[0] + d, d, dtype)

    def forward(self, x: torch.Tensor):
        x4, x8, x16, x32 = self.convnext(x)
        x16 = self.decode_16x(torch.cat([x16, self.upconv_16(x32)], dim=-1))
        x8 = self.decode_8x(torch.cat([x8, self.upconv_8(x16)], dim=-1))
        x4 = self.decode_4x(torch.cat([x4, self.upconv_4(x8)], dim=-1))
        return x4, x8, x16
