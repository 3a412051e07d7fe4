"""BiDAStereo: bidirectional-alignment video stereo (counterpart of
ppmstereo_tpu/models/bidastereo.py).

A frozen RAFT (`models/raft.py`) gives the optical flow between consecutive
right frames in both directions; the right features are warped along it,
and each iteration correlates the left features with three temporally
aligned right features (TFCL, patches alternating between (1, 9) and
(3, 3)). One shared update block (a bidirectionally warped 48-channel
motion state, SKSepConvGRU3D) runs the 1/16 -> 1/8 -> 1/4 cascade with
positive rescaling between stages; there is no SST and no memory.

TFCL, the flow warps and RAFT's 2-D lookup are XLA code in the JAX package,
not Pallas kernels, and stay plain PyTorch here: the model launches no
kernel of the port. Tensors are (B, T, H, W, C); images are in [0, 255].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.models.dynamic_stereo import upsample_flow_2d
from ppmstereo_tpu_torch.models.raft import RAFTConfig, RAFTFlowProvider
from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder
from ppmstereo_tpu_torch.nn.gru import SKSepConvGRU3D
from ppmstereo_tpu_torch.nn.update import MOTION_DIM, FlowHead
from ppmstereo_tpu_torch.ops.corr import bilinear_sample_2d, tfcl_correlation
from ppmstereo_tpu_torch.ops.geometry import avg_pool2d, interp_bilinear
from ppmstereo_tpu_torch.utils.device import cudnn_autotune

MOTION_STATE = 48  # channels of the motion hidden state


@dataclass(frozen=True)
class BiDAStereoConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    mixed_precision: bool = False
    raft_iters: int = 10

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (N, H, W, C) by flow (N, H, W, 2): each pixel reads x at its
    position plus the flow (bilinear, zero padding, align-corners)."""
    n, h, w, _ = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    return bilinear_sample_2d(x, torch.stack([xs, ys], dim=-1)[None] + flow)


class MultiMotionEncoder(nn.Module):
    """corr, flow and the motion state warped forward and backward along the
    right frames' flow -> (motion features (126 + the flow), the new state)."""

    def __init__(self, cor_planes: int = 27, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cor_planes = cor_planes
        s = MOTION_STATE
        self.convc1 = Conv(cor_planes // 3, 96, (1, 1), padding=(0, 0), dtype=dtype)
        self.convc2 = Conv(3 * 96, 192, (3, 3), dtype=dtype)
        self.convf1 = Conv(2, 128, (7, 7), dtype=dtype)
        self.convf2 = Conv(128, 64, (3, 3), dtype=dtype)
        self.final_conv = Conv(192 + 64 + 3 * s, 126 + s, (3, 3), dtype=dtype)
        self.init_hidden_state = nn.Parameter(torch.randn(1, 1, 1, 1, s))

    def init_hidden(self, b: int, t: int, h: int, w: int) -> torch.Tensor:
        return self.init_hidden_state.to(self.dtype).expand(b, t, h, w, MOTION_STATE)

    def forward(self, motion_hidden_state, flow_fw, flow_bw, flow, corr):
        """motion_hidden_state (B,T,H,W,48); flow_fw/bw (B,T-1,H,W,2); flow
        (B,T,H,W,2); corr (B,T,H,W,27)."""
        b, t, h, w, s = motion_hidden_state.shape
        mhs = motion_hidden_state

        def warp(x, f):
            return flow_warp(x.reshape(b * (t - 1), h, w, s),
                             f.reshape(b * (t - 1), h, w, 2)).reshape(b, t - 1, h, w, s)

        bw = torch.cat([warp(mhs[:, 1:], flow_bw), mhs[:, -1:]], dim=1)
        fw = torch.cat([mhs[:, :1], warp(mhs[:, : t - 1], flow_fw)], dim=1)
        p = self.cor_planes // 3
        cor = torch.cat([self.convc1(corr[..., i * p: (i + 1) * p]) for i in range(3)], dim=-1)
        cor = F.relu(self.convc2(F.gelu(cor)))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.final_conv(torch.cat([cor, flo, fw, bw, mhs], dim=-1)))
        motion, hidden = out[..., :126], out[..., 126:]
        return torch.cat([motion, flow], dim=-1), hidden


class MultiSequenceUpdateBlock3D(nn.Module):
    """The shared update cell: motion encoder, SKSepConvGRU3D, the 3x3x3
    flow head and the 2-D mask head of the convex upsample by 4."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 27,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, m = hidden_dim, MOTION_DIM
        self.encoder = MultiMotionEncoder(cor_planes, dtype)
        self.gru = SKSepConvGRU3D(d, d + m, dtype)
        self.flow_head = FlowHead(d, dtype)
        self.mask_conv1 = Conv(d, d + m, (3, 3), dtype=dtype)
        self.mask_conv2 = Conv(d + m, 9 * 4 * 4, (1, 1), padding=(0, 0), dtype=dtype)

    def get_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))

    def forward(self, net, inp, corrs, flow, motion_hidden_state, flow_fw, flow_bw):
        """Returns (net, delta_flow, motion_hidden_state); the mask is read
        by the caller (`get_mask`) where it is used."""
        motion, motion_hidden_state = self.encoder(motion_hidden_state, flow_fw, flow_bw,
                                                   flow, corrs)
        net = self.gru(net, torch.cat([inp, motion], dim=-1))
        return net, self.flow_head(net), motion_hidden_state


class BiDAStereo(nn.Module):
    """BiDAStereo over (B, T, H, W, 3) [0, 255] stereo clips, T >= 2.

    test_mode=True:  -> disparity (B, T, H, W, 1), signed x-flow
    test_mode=False: -> predictions (n, B, T, H, W, 1) of all
                        n = 2 (iters // 2) + iters iterations (training)"""

    def __init__(self, cfg: BiDAStereoConfig = BiDAStereoConfig(), iters: int = 10,
                 test_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.test_mode = test_mode
        self.dtype = cfg.dtype
        self.raft = RAFTFlowProvider(RAFTConfig(), cfg.raft_iters)
        self.fnet = BasicEncoder(256, cfg.dtype)
        self.update_block = MultiSequenceUpdateBlock3D(cfg.hidden_dim, 27, cfg.dtype)

    def compute_flows(self, seq2: torch.Tensor):
        """The frozen RAFT's 1/4 flows between consecutive right frames:
        (fw, bw), each (B, T-1, H/4, W/4, 2); bw[i] takes frame i to i+1,
        fw[i] frame i+1 to i (the reference's orientation)."""
        b, t, h, w, _ = seq2.shape
        prev = seq2[:, :-1].reshape(b * (t - 1), h, w, 3)
        nxt = seq2[:, 1:].reshape(b * (t - 1), h, w, 3)
        with torch.no_grad():
            flow_bw = self.raft(prev, nxt)
            flow_fw = self.raft(nxt, prev)
        h4, w4 = flow_bw.shape[1], flow_bw.shape[2]
        return flow_fw.reshape(b, t - 1, h4, w4, 2), flow_bw.reshape(b, t - 1, h4, w4, 2)

    def _stage(self, left, rights, flow, net, inp, mhs, flow_fw, flow_bw, iters: int,
               interp_scale: int, preds: list):
        """One cascade scale: TFCL with the patch alternating by iteration,
        then the shared update block."""
        b, t, h, w, _ = flow.shape
        collect = not self.test_mode
        flow_up = None
        for itr in range(iters):
            psize = (3, 3) if itr % 2 == 1 else (1, 9)
            # the reference zeroes the y flow in place inside TFCL every
            # iteration (ppmstereo_tpu/models/bidastereo.py:196-201)
            flow = torch.cat([flow[..., :1], torch.zeros_like(flow[..., 1:])], dim=-1)
            grid = flow.reshape(b * t, h, w, 2)
            warped = [flow_warp(cr.reshape(b * t, h, w, -1), grid) for cr in rights]
            corrs = tfcl_correlation(left.reshape(b * t, h, w, -1), warped, psize)
            corrs = corrs.reshape(b, t, h, w, -1).to(self.dtype)
            net, delta, mhs = self.update_block(net, inp, corrs, flow.to(self.dtype), mhs,
                                                flow_fw, flow_bw)
            flow = flow + delta.float()
            if collect or itr == iters - 1:  # test mode upsamples the last one only
                flow_up = upsample_flow_2d(flow, self.update_block.get_mask(net))
            if collect:
                up = flow_up
                if interp_scale > 1:
                    up = interp_scale * interp_bilinear(
                        up, (interp_scale * up.shape[2], interp_scale * up.shape[3]))
                preds.append(up[..., :1])
        return flow, flow_up, net, mhs

    def forward(self, seq1: torch.Tensor, seq2: torch.Tensor, flows=None):
        """flows: the RAFT flows ((B,T-1,H/4,W/4,2) fw, bw) when given;
        otherwise the frozen RAFT computes them (`compute_flows`)."""
        with cudnn_autotune(self.dtype == torch.float32):
            return self._forward(seq1, seq2, flows)

    def _forward(self, seq1: torch.Tensor, seq2: torch.Tensor, flows=None):
        b, t = seq1.shape[0], seq1.shape[1]
        if t < 2:
            raise ValueError(f"BiDAStereo needs clips of 2 or more frames, got {t}")
        flow_fw4, flow_bw4 = self.compute_flows(seq2) if flows is None else flows
        dtype = self.dtype
        seq1n = (2.0 * (seq1 / 255.0) - 1.0).to(dtype)
        seq2n = (2.0 * (seq2 / 255.0) - 1.0).to(dtype)
        fmaps = self.fnet(torch.cat([seq1n, seq2n], dim=0))
        fmap1, fmap2 = fmaps[:b].float(), fmaps[b:].float()
        h4, w4 = fmap1.shape[2], fmap1.shape[3]

        def scale_flow(f, s):
            # the 1/8 and 1/16 flows are resized straight from the 1/4 flow
            # (ppmstereo_tpu/models/bidastereo.py:249-256)
            return (1.0 / s) * interp_bilinear(f, (f.shape[2] // s, f.shape[3] // s))

        def shift_warp(fm, f, backward: bool):
            inner = (fm[:, 1:] if backward else fm[:, : t - 1]).reshape(b * (t - 1), h4, w4, -1)
            warped = flow_warp(inner, f.reshape(b * (t - 1), h4, w4, 2))
            warped = warped.reshape(b, t - 1, h4, w4, -1)
            return torch.cat([warped, fm[:, -1:]] if backward else [fm[:, :1], warped], dim=1)

        rights4 = (fmap2, shift_warp(fmap2, flow_fw4, False), shift_warp(fmap2, flow_bw4, True))
        net = torch.tanh(fmap1[..., : self.cfg.hidden_dim]).to(dtype)
        inp = F.relu(fmap1[..., self.cfg.hidden_dim:]).to(dtype)

        preds: list = []
        half = max(self.iters // 2, 1)
        enc = self.update_block.encoder
        # 1/16
        flow16 = torch.zeros(b, t, h4 // 4, w4 // 4, 2, device=fmap1.device)
        _, up16, _, mhs16 = self._stage(
            avg_pool2d(fmap1, 4), tuple(avg_pool2d(x, 4) for x in rights4), flow16,
            avg_pool2d(net, 4), avg_pool2d(inp, 4), enc.init_hidden(b, t, h4 // 4, w4 // 4),
            scale_flow(flow_fw4, 4), scale_flow(flow_bw4, 4), half, 4, preds)
        # 1/8: positive rescale, no negation (ppmstereo_tpu/models/bidastereo.py:299)
        h8, w8 = h4 // 2, w4 // 2
        flow8 = (h8 / up16.shape[2]) * interp_bilinear(up16, (h8, w8))
        _, up8, _, mhs8 = self._stage(
            avg_pool2d(fmap1, 2), tuple(avg_pool2d(x, 2) for x in rights4), flow8,
            avg_pool2d(net, 2), avg_pool2d(inp, 2), interp_bilinear(mhs16, (h8, w8)),
            scale_flow(flow_fw4, 2), scale_flow(flow_bw4, 2), half, 2, preds)
        # 1/4
        flow4 = (h4 / up8.shape[2]) * interp_bilinear(up8, (h4, w4))
        _, up4, _, _ = self._stage(fmap1, rights4, flow4, net, inp,
                                   interp_bilinear(mhs8, (h4, w4)), flow_fw4, flow_bw4,
                                   self.iters, 1, preds)
        if self.test_mode:
            return up4[..., :1]
        return torch.stack(preds)
