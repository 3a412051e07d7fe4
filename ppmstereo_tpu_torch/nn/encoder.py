"""RAFT-style feature encoder, channels-last (counterpart of
ppmstereo_tpu/nn/encoder.py::ResidualBlock, BasicEncoder).

7x7 stride-2 stem and three residual stages -> 1/4 resolution, `output_dim`
channels, instance norm. Left and right frames are folded into the batch
axis by the caller.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.norm import InstanceNorm


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm(self.Conv_0(x)))
        for i in range(6):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return self.Conv_1(x)
