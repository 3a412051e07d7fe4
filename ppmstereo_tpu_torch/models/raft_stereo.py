"""RAFT-Stereo: per-pair stereo matching (counterpart of
ppmstereo_tpu/models/raft_stereo.py), at the reference's shipped arguments:
hidden dims 128 x 3, a 4-level radius-4 1-D correlation pyramid, two
downsamples (1/4), three GRU levels updated 1/16 -> 1/8 -> 1/4 every
iteration, batch-norm context encoder, f32.

Inference only (the JAX model has no train mode). Each iteration's lookup is
kernel 6 (`kernels/corr_lookup.py`) on the f32 pyramid of the whole batch,
writing features in the model's dtype: one launch an iteration. CPU tensors
take its plain version.

Images are (N, H, W, 3) in [0, 255]; the disparity (N, H, W, 1) is the
signed x-flow.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.kernels.corr_lookup import corr_lookup_kernel
from ppmstereo_tpu_torch.models.raft import RAFTEncoder, RAFTResidualBlock, RAFTTrunk
from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid
from ppmstereo_tpu_torch.ops.geometry import coords_grid_x, interp_bilinear
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_2d
from ppmstereo_tpu_torch.utils.device import cudnn_autotune


@dataclass(frozen=True)
class RAFTStereoConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    n_gru_layers: int = 3
    mixed_precision: bool = False

    def __post_init__(self):
        if self.n_gru_layers != 3:
            raise ValueError(f"n_gru_layers={self.n_gru_layers}: the update block runs three "
                             "GRU levels, as the JAX model's does")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


def _pool2x(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(3, stride 2, padding 1) over (H, W) of (B,H,W,C), the
    padding counted (RAFT-Stereo's pool2x)."""
    y = F.avg_pool2d(x.movedim(-1, 1), 3, stride=2, padding=1, count_include_pad=True)
    return y.movedim(1, -1)


class RSMultiEncoder(RAFTTrunk):
    """The context encoder at two downsamples: the trunk at stem stride 1,
    layers 4 and 5 (stride 2), and per scale a [hidden, context] pair of
    heads, finest first. The heads keep the reference's 08/16/32 labels,
    which mean 1/4, 1/8 and 1/16 here."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128, norm_fn: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__(norm_fn, 1, dtype)
        for li in (4, 5):
            self.add_module(f"layer{li}_0", RAFTResidualBlock(128, 128, norm_fn, 2, dtype))
            self.add_module(f"layer{li}_1", RAFTResidualBlock(128, 128, norm_fn, 1, dtype))
        for i, d in enumerate((hidden_dim, context_dim)):
            for label in ("outputs08", "outputs16"):
                self.add_module(f"{label}_{i}_res",
                                RAFTResidualBlock(128, 128, norm_fn, 1, dtype))
                self.add_module(f"{label}_{i}_conv", Conv(128, d, (3, 3), dtype=dtype))
            self.add_module(f"outputs32_{i}_conv", Conv(128, d, (3, 3), dtype=dtype))

    def forward(self, x: torch.Tensor):
        x04 = self.trunk(x)
        x08 = self.layer4_1(self.layer4_0(x04))
        x16 = self.layer5_1(self.layer5_0(x08))
        heads = []
        for label, feat in (("outputs08", x04), ("outputs16", x08)):
            heads.append(tuple(getattr(self, f"{label}_{i}_conv")(
                getattr(self, f"{label}_{i}_res")(feat)) for i in (0, 1)))
        heads.append(tuple(getattr(self, f"outputs32_{i}_conv")(x16) for i in (0, 1)))
        return tuple(heads)


class RSContextGRU(nn.Module):
    """RAFT-Stereo's ConvGRU: 3x3 gate convs on cat[h, x] with the context's
    gate biases added before the nonlinearity."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = Conv(cin, hidden_dim, (3, 3), dtype=dtype)
        self.convr = Conv(cin, hidden_dim, (3, 3), dtype=dtype)
        self.convq = Conv(cin, hidden_dim, (3, 3), dtype=dtype)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=-1)
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)) + cq)
        return (1 - z) * h + z * q


class RSMotionEncoder(nn.Module):
    """RAFT-Stereo's 64-channel motion encoder -> 128 channels (126 + the
    flow)."""

    def __init__(self, cor_planes: int = 36, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convc1 = Conv(cor_planes, 64, (1, 1), padding=(0, 0), dtype=dtype)
        self.convc2 = Conv(64, 64, (3, 3), dtype=dtype)
        self.convf1 = Conv(2, 64, (7, 7), dtype=dtype)
        self.convf2 = Conv(64, 64, (3, 3), dtype=dtype)
        self.conv = Conv(128, 126, (3, 3), dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


class RSUpdateBlock(nn.Module):
    """The multi-level update: 1/16, then 1/8, then 1/4 every iteration, the
    flow head and the mask head of the convex upsample by 4."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 36,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = hidden_dim
        self.encoder = RSMotionEncoder(cor_planes, dtype)
        self.gru04 = RSContextGRU(d, 128 + d, dtype)
        self.gru08 = RSContextGRU(d, 2 * d, dtype)
        self.gru16 = RSContextGRU(d, d, dtype)
        self.flow_conv1 = Conv(d, 256, (3, 3), dtype=dtype)
        self.flow_conv2 = Conv(256, 2, (3, 3), dtype=dtype)
        self.mask_conv1 = Conv(d, 256, (3, 3), dtype=dtype)
        self.mask_conv2 = Conv(256, 16 * 9, (1, 1), padding=(0, 0), dtype=dtype)

    def get_mask(self, net04: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net04)))

    def forward(self, nets, ctx_gates, corr, flow):
        """Returns ((net04, net08, net16), delta_flow)."""
        net04, net08, net16 = nets
        g04, g08, g16 = ctx_gates  # each (cz, cr, cq)
        net16 = self.gru16(net16, *g16, _pool2x(net08))
        net08 = self.gru08(net08, *g08, _pool2x(net04),
                           interp_bilinear(net16, (net08.shape[1], net08.shape[2])))
        motion = self.encoder(flow, corr)
        net04 = self.gru04(net04, *g04, motion,
                           interp_bilinear(net08, (net04.shape[1], net04.shape[2])))
        delta = self.flow_conv2(F.relu(self.flow_conv1(net04)))
        return (net04, net08, net16), delta


class RAFTStereo(nn.Module):
    """forward: (N, H, W, 3) pairs in [0, 255] -> disparity (N, H, W, 1)."""

    def __init__(self, cfg: RAFTStereoConfig = RAFTStereoConfig(), iters: int = 32):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.dtype = dtype = cfg.dtype
        self.fnet = RAFTEncoder(256, "instance", dtype, stem_stride=1)
        self.cnet = RSMultiEncoder(cfg.hidden_dim, cfg.context_dim, "batch", dtype)
        self.update_block = RSUpdateBlock(cfg.hidden_dim,
                                          cfg.corr_levels * (2 * cfg.corr_radius + 1), dtype)
        # per-scale context -> (cz | cr | cq) gate biases
        for i in range(cfg.n_gru_layers):
            self.add_module(f"context_zqr_convs_{i}",
                            Conv(cfg.context_dim, 3 * cfg.hidden_dim, (3, 3), dtype=dtype))

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        with cudnn_autotune(self.dtype == torch.float32):
            return self._forward(image1, image2)

    def _forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.cfg, self.dtype
        n = image1.shape[0]
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(dtype)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(dtype)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = fmaps[:n].float(), fmaps[n:].float()
        h4, w4 = fmap1.shape[1], fmap1.shape[2]

        ctx = self.cnet(image1)  # ((hidden, context) per scale, finest first)
        nets = tuple(torch.tanh(h) for h, _ in ctx)
        gates = tuple(tuple(torch.chunk(getattr(self, f"context_zqr_convs_{i}")(F.relu(c)), 3,
                                        dim=-1))
                      for i, (_, c) in enumerate(ctx))

        # the f32 pyramid of the whole batch: each level (N, H/4, W/4, W/4 / 2^i)
        pyramid = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels)
        coords0 = coords_grid_x(n, h4, w4, device=fmap1.device)
        flow = torch.zeros(n, h4, w4, 2, device=fmap1.device)
        for _ in range(self.iters):
            corr = corr_lookup_kernel(pyramid, coords0 + flow[..., 0], cfg.corr_radius,
                                      out_dtype=dtype)
            nets, delta = self.update_block(nets, gates, corr, flow.to(dtype))
            # stereo: the update's y component is zeroed
            flow = flow + torch.cat([delta[..., :1], torch.zeros_like(delta[..., 1:])],
                                    dim=-1).float()
        # only the final mask is read
        flow_up = convex_upsample_2d(flow, self.update_block.get_mask(nets[0]), rate=4)
        return flow_up[..., :1]


class RAFTStereoVideoAdapter(RAFTStereo):
    """RAFT-Stereo over a clip: (B, T, H, W, 3) pairs fold into the batch
    (RAFT-Stereo has no temporal model) -> (disparity (B,T,H,W,1), zero
    uncertainty like it). Its parameters are RAFTStereo's, unprefixed, as
    the JAX package's adapter keeps them."""

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        b, t, h, w, _ = left.shape
        disp = super().forward(left.reshape(b * t, h, w, 3), right.reshape(b * t, h, w, 3))
        disp = disp.reshape(b, t, h, w, 1)
        return disp, torch.zeros_like(disp)
