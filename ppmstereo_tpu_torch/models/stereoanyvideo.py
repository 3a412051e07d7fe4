"""StereoAnyVideo: video stereo with a frozen monocular-depth prior
(counterpart of ppmstereo_tpu/models/stereoanyvideo.py).

Frozen Video-Depth-Anything features (32 channels at 1/4,
`nn/vda/video_depth.py::DepthExtractor`) joined to 96-channel encoder
features, ImageNet-normalised input, the all-in-all-pair correlation (AAPC)
of the left features with the right ones warped by the current disparity,
its patch alternating between (1, 9) and (3, 3) by iteration, a corr MLP
(4 x 81 -> 128), one update block shared by the 1/16 -> 1/8 -> 1/4 cascade
(positive rescaling between stages) and the 3-D convex upsample.

AAPC, the warps and the attention are XLA code in the JAX package, not
Pallas kernels, and stay plain PyTorch here: the model launches no kernel
of the port. In f32 (the shipped configuration) it runs under cuDNN's
benchmark mode (`utils/device.py::cudnn_autotune`). Tensors are
(B, T, H, W, C); images are in [0, 255].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Dense
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder
from ppmstereo_tpu_torch.nn.update import SAVSequenceUpdateBlock3D
from ppmstereo_tpu_torch.nn.vda.video_depth import (
    _MODEL_CONFIGS,
    DepthExtractor,
    imagenet_normalize,
)
from ppmstereo_tpu_torch.ops.corr import aapc_correlation, bilinear_sample_2d
from ppmstereo_tpu_torch.ops.geometry import avg_pool2d, interp_bilinear
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_3d
from ppmstereo_tpu_torch.utils.device import cudnn_autotune


HIDDEN_DIM = 128  # the GRU state: the context's 32 depth and 96 encoder channels


@dataclass(frozen=True)
class StereoAnyVideoConfig:
    """The JAX package's `StereoAnyVideoConfig` with its defaults, less the
    fields that admit one value here: its hidden_dim (HIDDEN_DIM, the
    context's width) and remat (an XLA memory switch)."""

    mixed_precision: bool = False
    encoder: str = "vits"

    def __post_init__(self):
        if self.encoder not in _MODEL_CONFIGS:
            raise ValueError(f"encoder {self.encoder!r}: Video-Depth-Anything has "
                             f"{sorted(_MODEL_CONFIGS)}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


def _warp_x(right: torch.Tensor, flow_x: torch.Tensor) -> torch.Tensor:
    """right (B,T,H,W,C) read at x + flow_x (B,T,H,W), bilinear, zero padding."""
    b, t, h, w, c = right.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=right.device),
                            torch.arange(w, dtype=torch.float32, device=right.device),
                            indexing="ij")
    coords = torch.stack([xs + flow_x.reshape(b * t, h, w), ys.expand(b * t, h, w)], dim=-1)
    return bilinear_sample_2d(right.reshape(b * t, h, w, c), coords).reshape(b, t, h, w, c)


class StereoAnyVideo(nn.Module):
    """StereoAnyVideo over (B, T, H, W, 3) [0, 255] stereo clips.

    test_mode=True:  -> disparity (B, T, H, W, 1), signed x-flow
    test_mode=False: -> predictions (n, B, T, H, W, 1) of all
                        n = 2 (iters // 2) + iters iterations (training)"""

    def __init__(self, cfg: StereoAnyVideoConfig = StereoAnyVideoConfig(), iters: int = 12,
                 test_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.test_mode = test_mode
        self.dtype = dtype = cfg.dtype
        self.cnet = BasicEncoder(96, dtype)
        self.fnet = BasicEncoder(96, dtype)
        self.depthnet = DepthExtractor(cfg.encoder, dtype)
        self.corr_mlp_fc1 = Dense(4 * 81, 256, dtype=dtype)
        self.corr_mlp_fc2 = Dense(256, 128, dtype=dtype)
        self.update_block = SAVSequenceUpdateBlock3D(HIDDEN_DIM, 128, dtype)

    def corr_mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.corr_mlp_fc2(F.gelu(self.corr_mlp_fc1(x)))

    def _one_iter(self, left, right, flow, net, inp, psize, compute_mask: bool):
        """One AAPC and update-block iteration. The reference zeroes the y
        flow in place inside AAPC every iteration, so the update block
        always sees y = 0 and y deltas never accumulate."""
        b, t, h, w, _ = flow.shape
        flow = torch.cat([flow[..., :1], torch.zeros_like(flow[..., 1:])], dim=-1)
        warped = _warp_x(right, -flow[..., 0])  # AAPC reads coords - flow
        corrs = aapc_correlation(left.reshape(b * t, h, w, -1),
                                 warped.reshape(b * t, h, w, -1), psize)
        corrs = self.corr_mlp(corrs.reshape(b, t, h, w, -1).to(self.dtype))
        out = self.update_block(net, inp, corrs, flow.to(self.dtype), compute_mask)
        return flow + out[1].float(), out[0], out[2] if compute_mask else None

    def _stage(self, left, right, flow, net, inp, iters: int, interp_scale: int, preds: list):
        """One cascade scale; the patch alternates (1, 9), (3, 3) by
        iteration. Returns the final flow upsampled by 4 (each stage starts
        its GRU state afresh from the pooled context)."""
        collect = not self.test_mode
        for itr in range(iters):
            psize = (1, 9) if itr % 2 == 0 else (3, 3)
            flow, net, mask = self._one_iter(left, right, flow, net, inp, psize, collect)
            if collect:
                up = convex_upsample_3d(flow, mask, rate=4)
                if interp_scale > 1:
                    up = interp_scale * interp_bilinear(
                        up, (interp_scale * up.shape[2], interp_scale * up.shape[3]))
                preds.append(up[..., :1])
        return convex_upsample_3d(flow, self.update_block.get_mask(net), rate=4)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        with cudnn_autotune(self.dtype == torch.float32):
            return self._forward(image1, image2)

    def _forward(self, image1, image2):
        b, t = image1.shape[0], image1.shape[1]
        img1 = imagenet_normalize(image1).to(self.dtype)
        img2 = imagenet_normalize(image2).to(self.dtype)
        d1, d2 = self.depthnet(img1), self.depthnet(img2)
        f_all = self.fnet(torch.cat([img1, img2], dim=0))
        c1 = self.cnet(img1)
        fmap1 = torch.cat([d1, f_all[:b]], dim=-1).float()
        fmap2 = torch.cat([d2, f_all[b:]], dim=-1).float()
        context = torch.cat([d1, c1], dim=-1)
        net, inp = torch.tanh(context), F.relu(context)

        h4, w4 = fmap1.shape[2], fmap1.shape[3]
        half = max(self.iters // 2, 1)
        preds: list = []
        flow16 = torch.zeros(b, t, h4 // 4, w4 // 4, 2, device=fmap1.device)
        up16 = self._stage(avg_pool2d(fmap1, 4), avg_pool2d(fmap2, 4), flow16,
                           avg_pool2d(net, 4), avg_pool2d(inp, 4), half, 4, preds)
        h8, w8 = h4 // 2, w4 // 2
        flow8 = (h8 / up16.shape[2]) * interp_bilinear(up16, (h8, w8))
        up8 = self._stage(avg_pool2d(fmap1, 2), avg_pool2d(fmap2, 2), flow8,
                          avg_pool2d(net, 2), avg_pool2d(inp, 2), half, 2, preds)
        flow4 = (h4 / up8.shape[2]) * interp_bilinear(up8, (h4, w4))
        up4 = self._stage(fmap1, fmap2, flow4, net, inp, self.iters, 1, preds)
        if self.test_mode:
            return up4[..., :1]
        return torch.stack(preds)
