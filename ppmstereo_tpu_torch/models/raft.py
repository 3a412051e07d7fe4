"""RAFT optical flow, the frozen flow provider of BiDAStereo (counterpart of
ppmstereo_tpu/models/raft.py).

The published RAFT architecture (Teed and Deng, ECCV 2020): feature and
context encoders at 1/8 (instance norm and frozen batch norm), a 4-level
all-pairs 2-D correlation pyramid with a (2r+1)^2 bilinear lookup, the 2-D
separable GRU, and the convex upsample by 8. Module names follow the JAX
package's (which mirror the reference state dict). The 2-D pyramid and its
lookup are XLA code in the JAX package, not Pallas kernels, and stay plain
PyTorch here.

Images are (B, H, W, 3) in [0, 255]; flow is (B, H, W, 2), (x, y).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.gru import SepConvGRU
from ppmstereo_tpu_torch.nn.norm import InstanceNorm
from ppmstereo_tpu_torch.ops.corr import bilinear_sample_2d
from ppmstereo_tpu_torch.ops.geometry import interp_bilinear
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_2d


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32


class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm over the last axis: the JAX package's
    `scale`, `bias`, `mean` and `var` leaves, here `weight` (the carry's
    rename of `scale`), `bias`, and the buffers `mean` and `var`. The result
    is f32 (the JAX module promotes a bf16 input against its f32 leaves)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.var + self.epsilon)
        return (x.float() - self.mean) * inv + self.bias


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "batch":
        return FrozenBatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm()
    raise ValueError(f"norm_fn {norm_fn!r}: batch or instance")


class RAFTResidualBlock(nn.Module):
    """RAFT's residual block: norms inside it, and the 1x1 projection
    (`downsample`, `norm3`) only at stride > 1."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, (3, 3), stride=stride, dtype=dtype)
        self.norm1 = make_norm(norm_fn, planes)
        self.conv2 = Conv(planes, planes, (3, 3), dtype=dtype)
        self.norm2 = make_norm(norm_fn, planes)
        self.stride = stride
        if stride > 1:
            self.downsample = Conv(in_planes, planes, (1, 1), stride=stride, padding=(0, 0),
                                   dtype=dtype)
            self.norm3 = make_norm(norm_fn, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.stride > 1:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class RAFTTrunk(nn.Module):
    """The 7x7 stem (`stem_stride`) and three residual stages of 64 (stride
    1), 96 (2) and 128 (2) channels: RAFT's encoders at stem stride 2 (1/8),
    RAFT-Stereo's at 1 (1/4)."""

    def __init__(self, norm_fn: str, stem_stride: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(3, 64, (7, 7), stride=stem_stride, dtype=dtype)
        self.norm1 = make_norm(norm_fn, 64)
        planes_in = 64
        for li, (planes, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            self.add_module(f"layer{li}_0",
                            RAFTResidualBlock(planes_in, planes, norm_fn, stride, dtype))
            self.add_module(f"layer{li}_1", RAFTResidualBlock(planes, planes, norm_fn, 1, dtype))
            planes_in = planes

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        for li in (1, 2, 3):
            x = getattr(self, f"layer{li}_1")(getattr(self, f"layer{li}_0")(x))
        return x


class RAFTEncoder(RAFTTrunk):
    """RAFT's encoder at 1/8: the trunk at stem stride 2 and a 1x1 output
    conv (`conv2`)."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 dtype: torch.dtype = torch.float32, stem_stride: int = 2):
        super().__init__(norm_fn, stem_stride, dtype)
        self.conv2 = Conv(128, output_dim, (1, 1), padding=(0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.trunk(x))


def build_corr_pyramid_2d(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          num_levels: int = 4) -> list[torch.Tensor]:
    """All-pairs 2-D correlation of (B,H,W,C) maps, f32, / sqrt(C): level i
    is (B H W, H / 2^i, W / 2^i, 1), each level the 2x2 mean of the last (an
    odd row or column dropped)."""
    b, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, h * w, c).float(),
                        fmap2.reshape(b, h * w, c).float().transpose(1, 2))
    corr = (corr / math.sqrt(c)).reshape(b * h * w, h, w, 1)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        n, hh, ww, _ = corr.shape
        corr = corr[:, : hh // 2 * 2, : ww // 2 * 2]
        corr = corr.reshape(n, hh // 2, 2, ww // 2, 2, 1).mean(dim=(2, 4))
        pyramid.append(corr)
    return pyramid


def corr_lookup_2d(pyramid: list[torch.Tensor], coords: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """coords (B,H,W,2) target positions (x, y) -> (B,H,W, L (2r+1)^2)
    features, level-major. Within a level the x offset varies along the
    outer tap index and y along the inner (RAFT's tap order, which imported
    convc1 weights need)."""
    b, h, w, _ = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dgrid = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (2r+1, 2r+1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        pos = coords.reshape(b * h * w, 1, 1, 2) / (2.0**i) + dgrid
        out.append(bilinear_sample_2d(corr, pos).reshape(b, h, w, (2 * radius + 1) ** 2))
    return torch.cat(out, dim=-1)


class RAFTMotionEncoder(nn.Module):
    """corr + flow -> 128-ch motion features (126 + the flow); `Conv_0` ..
    `Conv_4` as in the JAX module."""

    def __init__(self, cor_planes: int = 324, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cor_planes, 256, (1, 1), padding=(0, 0), dtype=dtype)
        self.Conv_1 = Conv(256, 192, (3, 3), dtype=dtype)
        self.Conv_2 = Conv(2, 128, (7, 7), dtype=dtype)
        self.Conv_3 = Conv(128, 64, (3, 3), dtype=dtype)
        self.Conv_4 = Conv(192 + 64, 126, (3, 3), dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.Conv_1(F.relu(self.Conv_0(corr))))
        flo = F.relu(self.Conv_3(F.relu(self.Conv_2(flow))))
        out = F.relu(self.Conv_4(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


class RAFTUpdateBlock(nn.Module):
    """Motion encoder, SepConvGRU, flow head and the mask head of the convex
    upsample by 8 (9 x 8 x 8 channels)."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128, cor_planes: int = 324,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = hidden_dim
        self.encoder = RAFTMotionEncoder(cor_planes, dtype)
        self.gru = SepConvGRU(d, context_dim + 128, dtype)
        self.flow_conv1 = Conv(d, 256, (3, 3), dtype=dtype)
        self.flow_conv2 = Conv(256, 2, (3, 3), dtype=dtype)
        self.mask_conv1 = Conv(d, 256, (3, 3), dtype=dtype)
        self.mask_conv2 = Conv(256, 64 * 9, (1, 1), padding=(0, 0), dtype=dtype)

    def get_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))

    def forward(self, net, inp, corr, flow):
        """Returns (net, delta_flow); the mask is read after the loop."""
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], dim=-1))
        return net, self.flow_conv2(F.relu(self.flow_conv1(net)))


class RAFT(nn.Module):
    """forward(image1, image2): (B, H, W, 3) in [0, 255] -> (flow at 1/8,
    flow at full resolution), each (.., 2) f32."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig(), iters: int = 10):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.dtype = cfg.dtype
        self.fnet = RAFTEncoder(256, "instance", cfg.dtype)
        self.cnet = RAFTEncoder(cfg.hidden_dim + cfg.context_dim, "batch", cfg.dtype)
        self.update_block = RAFTUpdateBlock(cfg.hidden_dim, cfg.context_dim,
                                            cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2,
                                            cfg.dtype)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        cfg, dtype = self.cfg, self.dtype
        b = image1.shape[0]
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(dtype)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(dtype)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = fmaps[:b], fmaps[b:]
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[..., : cfg.hidden_dim])
        inp = F.relu(cnet[..., cfg.hidden_dim:])

        h8, w8 = fmap1.shape[1], fmap1.shape[2]
        pyramid = build_corr_pyramid_2d(fmap1, fmap2, cfg.corr_levels)
        ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=fmap1.device),
                                torch.arange(w8, dtype=torch.float32, device=fmap1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1).expand(b, h8, w8, 2)
        flow = torch.zeros(b, h8, w8, 2, device=fmap1.device)
        for _ in range(self.iters):
            corr = corr_lookup_2d(pyramid, coords0 + flow, cfg.corr_radius)
            net, delta = self.update_block(net, inp, corr.to(dtype), flow.to(dtype))
            flow = flow + delta.float()
        # only the final mask is read
        flow_up = convex_upsample_2d(flow, self.update_block.get_mask(net), rate=8)
        return flow, flow_up


class RAFTFlowProvider(nn.Module):
    """The reference's flow-provider contract: 0.25 x the bilinear
    (align-corners) resize of RAFT's full-resolution flow to 1/4."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig(), iters: int = 10):
        super().__init__()
        self.raft = RAFT(cfg, iters)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        _, flow_up = self.raft(image1, image2)
        h, w = flow_up.shape[1] // 4, flow_up.shape[2] // 4
        return 0.25 * interp_bilinear(flow_up, (h, w))
