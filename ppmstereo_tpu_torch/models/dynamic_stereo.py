"""DynamicStereo: cascaded SST video stereo without memory, in test and
train mode (counterpart of ppmstereo_tpu/models/dynamic_stereo.py).

The 1/16 -> 1/8 -> 1/4 cascade and SST attention of PPMStereo with no
context net, no pick-and-play memory and no uncertainty: a plain refinement
loop per scale (`DSUpdateLoop`) and the 2-D convex upsample by 4. Test mode
runs each iteration's pyramid lookup as kernel 6 (`kernels/corr_lookup.py`,
features written in the model's dtype), as PPMStereo does; train mode runs
the plain lookup (`ops/corr.py::corr_lookup`), which autograd
differentiates.

Tensors are (B, T, H, W, C) at the public boundary; images are in [0, 255].
Layers compute in the config's dtype (bf16 by default, the shipped
precision); the correlation's accumulation and the flow stay in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.kernels import corr_lookup as _lookup_kernel
from ppmstereo_tpu_torch.kernels.corr_lookup import corr_lookup_kernel
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder
from ppmstereo_tpu_torch.nn.sst import SSTBlock
from ppmstereo_tpu_torch.nn.update import DSSequenceUpdateBlock3D
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup
from ppmstereo_tpu_torch.ops.geometry import avg_pool2d, coords_grid_x, interp_bilinear
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_2d
from ppmstereo_tpu_torch.utils.device import cudnn_autotune

DS_ATTENTION = "self_stereo_temporal_update_time_update_space"


@dataclass(frozen=True)
class DynamicStereoConfig:
    """The JAX package's `DynamicStereoConfig` with its defaults (the shipped
    configuration). different_update_blocks=False raises, as in the JAX
    package (ppmstereo_tpu/models/dynamic_stereo.py:132-133); so do a lookup
    radius or level count beyond kernel 6's."""

    hidden_dim: int = 128
    dim: int = 256
    num_frames: int = 5
    attention_type: str = DS_ATTENTION
    sst_depth: int = 4
    different_update_blocks: bool = True
    corr_levels: int = 4
    corr_radius: int = 4
    mixed_precision: bool = True

    def __post_init__(self):
        if not self.different_update_blocks:
            raise NotImplementedError("shared update blocks not supported (as in the JAX "
                                      "package, ppmstereo_tpu/models/dynamic_stereo.py:132)")
        lk = _lookup_kernel
        if not (1 <= self.corr_radius <= lk.MAX_RADIUS and 1 <= self.corr_levels <= lk.MAX_LEVELS):
            raise ValueError(f"corr_levels={self.corr_levels}, corr_radius={self.corr_radius}: "
                             f"kernel 6 takes 1 to {lk.MAX_LEVELS} levels and a radius of 1 "
                             f"to {lk.MAX_RADIUS}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


def upsample_flow_2d(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The 2-D convex upsample by 4 of every frame: (B,T,H,W,2) with a
    (B,T,H,W,144) mask -> (B,T,4H,4W,2) f32."""
    b, t, h, w, _ = flow.shape
    up = convex_upsample_2d(flow.reshape(b * t, h, w, 2), mask.reshape(b * t, h, w, -1), 4)
    return up.reshape(b, t, 4 * h, 4 * w, 2)


class DSUpdateLoop(nn.Module):
    """One cascade stage: `iters` refinement iterations. In train mode
    (`collect_preds`) each iteration also yields its prediction at full
    resolution: the stage's grid is 1 / (4 * interp_scale) of the image."""

    def __init__(self, cfg: DynamicStereoConfig, iters: int, interp_scale: int,
                 collect_preds: bool, attention_type: str | None = None):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.interp_scale = interp_scale
        self.collect_preds = collect_preds
        self.update_block = DSSequenceUpdateBlock3D(
            cfg.hidden_dim, cfg.corr_levels * (2 * cfg.corr_radius + 1), attention_type,
            cfg.dtype)

    def forward(self, pyramid, coords0, flow, net, inp):
        """Returns (flow, flow_up (B,T,4H,4W,2), net, predictions): the
        predictions (iters, B, T, H_img, W_img, 1) in train mode, else None."""
        cfg, dtype, s = self.cfg, self.cfg.dtype, self.interp_scale
        b, t, h, w, _ = flow.shape
        mask, preds = None, []
        for _ in range(self.iters):
            coords_x = coords0 + flow[..., 0].reshape(b * t, h, w)
            if self.collect_preds:
                corrs = corr_lookup(pyramid, coords_x, cfg.corr_radius).to(dtype)
            else:
                corrs = corr_lookup_kernel(pyramid, coords_x, cfg.corr_radius, out_dtype=dtype)
            corrs = corrs.reshape(b, t, h, w, -1)
            if self.collect_preds:
                net, delta, mask = self.update_block(net, inp, corrs, flow.to(dtype),
                                                     compute_mask=True)
            else:
                net, delta = self.update_block(net, inp, corrs, flow.to(dtype))
            flow = flow + delta.float()
            if self.collect_preds:
                up = upsample_flow_2d(flow, mask)
                if s > 1:
                    up = s * interp_bilinear(up, (s * up.shape[2], s * up.shape[3]))
                preds.append(up[..., :1])
        if mask is None:
            # test mode reads the mask of the final state only, after the
            # loop (ppmstereo_tpu/models/dynamic_stereo.py:114)
            mask = self.update_block.get_mask(net)
        flow_up = upsample_flow_2d(flow, mask)
        return flow, flow_up, net, torch.stack(preds) if preds else None


class DynamicStereo(nn.Module):
    """DynamicStereo over (B, T, H, W, 3) [0, 255] stereo clips.

    test_mode=True:  -> disparity (B, T, H, W, 1), signed x-flow
    test_mode=False: -> predictions (n, B, T, H, W, 1) of all
                        n = 2 (iters // 2) + iters iterations (training)

    iters: the 1/4 stage's iterations (the 1/16 and 1/8 stages run
    iters // 2, at least 1). Autograd is the caller's choice: inference
    callers run it under `torch.no_grad()`."""

    def __init__(self, cfg: DynamicStereoConfig = DynamicStereoConfig(), iters: int = 10,
                 test_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.test_mode = test_mode
        self.dtype = cfg.dtype
        self.fnet = BasicEncoder(cfg.dim, cfg.dtype)
        self.sst = SSTBlock(cfg.dim, cfg.sst_depth, cfg.dtype, cfg.num_frames, cfg.attention_type)
        half, train = max(iters // 2, 1), not test_mode
        # only the 1/16 stage attends over time and space before its GRU
        self.update_block16 = DSUpdateLoop(cfg, half, 4, train, cfg.attention_type)
        self.update_block08 = DSUpdateLoop(cfg, half, 2, train)
        self.update_block04 = DSUpdateLoop(cfg, iters, 1, train)

    def _stage_inputs(self, fmap1, fmap2):
        b, t, h, w, _ = fmap1.shape
        pyramid = build_corr_pyramid(fmap1.reshape(b * t, h, w, -1),
                                     fmap2.reshape(b * t, h, w, -1), self.cfg.corr_levels)
        return pyramid, coords_grid_x(b * t, h, w, device=fmap1.device)

    def _context(self, feat):
        hdim = self.cfg.hidden_dim
        return torch.tanh(feat[..., :hdim]), F.relu(feat[..., hdim:])

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        with cudnn_autotune(self.dtype == torch.float32):
            return self._forward(image1, image2)

    def _forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        b = image1.shape[0]
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(self.dtype)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = fmaps[:b], fmaps[b:]
        net, inp = self._context(fmap1)
        t, h4, w4 = fmap1.shape[1:4]

        f1_16, f2_16 = self.sst(avg_pool2d(fmap1, 4), avg_pool2d(fmap2, 4))
        net16, inp16 = self._context(f1_16)
        h8, w8 = h4 // 2, w4 // 2
        f1_8 = (avg_pool2d(fmap1, 2) + interp_bilinear(f1_16, (h8, w8))) / 2.0
        f2_8 = (avg_pool2d(fmap2, 2) + interp_bilinear(f2_16, (h8, w8))) / 2.0
        net8, inp8 = self._context(f1_8)

        flow16 = torch.zeros(b, t, h4 // 4, w4 // 4, 2, device=fmap1.device)
        _, up16, net16, p16 = self.update_block16(*self._stage_inputs(f1_16, f2_16), flow16,
                                                  net16, inp16)
        # the coarser stage's upsampled flow seeds the next one negated, a
        # quirk of the reference that the JAX package reproduces
        # (ppmstereo_tpu/models/dynamic_stereo.py:202, :209)
        flow8 = -(h8 / up16.shape[2]) * interp_bilinear(up16, (h8, w8))
        net8 = (net8 + interp_bilinear(net16, (h8, w8))) / 2.0
        _, up8, net8, p8 = self.update_block08(*self._stage_inputs(f1_8, f2_8), flow8, net8,
                                               inp8)
        flow4 = -(h4 / up8.shape[2]) * interp_bilinear(up8, (h4, w4))
        net = (net + interp_bilinear(net8, (h4, w4))) / 2.0
        _, up4, _, p4 = self.update_block04(*self._stage_inputs(fmap1, fmap2), flow4, net, inp)

        if self.test_mode:
            return up4[..., :1]
        return torch.cat([p16, p8, p4])
