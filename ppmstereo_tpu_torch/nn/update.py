"""Sequence update block: the recurrent refinement cell of PPMStereo
(counterpart of ppmstereo_tpu/nn/update.py::FlowHead, Aggregate,
SequenceUpdateBlock3D; the 3-D convex-mask variant). Tensors are
(B, T, H, W, C)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.attention import SpaceAttnBlock, TimeAttnBlock
from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.gru import SKSepConvGRU3D
from ppmstereo_tpu_torch.nn.motion import BasicMotionEncoderV2

HIDDEN_DIM = 128
COR_PLANES = 4 * (2 * 4 + 1)  # 4 correlation levels x (2 * radius 4 + 1) taps


class FlowHead(nn.Module):
    """Two 3x3x3 convs (in_dim -> 256 -> 2) -> delta flow."""

    def __init__(self, in_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, 256, (3, 3, 3), dtype=dtype)
        self.Conv_1 = Conv(256, 2, (3, 3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.relu(self.Conv_0(x)))


class Aggregate(nn.Module):
    """Value projection and the zero-initialised blend scalar of the play
    step."""

    def __init__(self, dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.to_v = Conv(dim, dim, (1, 1), padding=(0, 0), use_bias=False, dtype=dtype)
        self.beta = nn.Parameter(torch.zeros(1))

    def forward(self, motion_features: torch.Tensor) -> torch.Tensor:
        return self.to_v(motion_features)


class SequenceUpdateBlock3D(nn.Module):
    """Motion encoder, 3-D separable GRU, flow / uncertainty heads and the
    mask head of the 3-D convex upsample by 4 (27 taps x 4 x 4 channels),
    at the shipped widths: hidden state and context 128, 4 levels x 9 taps
    of correlation. The first stage's cell also attends over time and space
    before its GRU (`with_attention`) and bootstraps the motion hidden
    state from the context (`with_init_hidden`)."""

    def __init__(self, with_attention: bool = False, with_init_hidden: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = HIDDEN_DIM
        self.encoder = BasicMotionEncoderV2(COR_PLANES, d, with_init_hidden, dtype)
        self.gru = SKSepConvGRU3D(d, 3 * d, dtype)
        self.flow_head = FlowHead(d, dtype)
        self.unc_conv1 = Conv(2 * d, d, (3, 3), dtype=dtype)
        self.unc_conv2 = Conv(d, 1, (1, 1), padding=(0, 0), dtype=dtype)
        self.mask_conv1 = Conv(d, 2 * d, (3, 3, 3), dtype=dtype)
        self.mask_conv2 = Conv(2 * d, 27 * 4 * 4, (1, 1, 1),
                               padding=(0, 0, 0), dtype=dtype)
        self.with_attention = with_attention
        if with_attention:
            self.time_attn = TimeAttnBlock(3 * d, 8, dtype)
            self.space_attn = SpaceAttnBlock(3 * d, 8, dtype)
        self.aggregator = Aggregate(d, dtype)

    def init_motion_hidden_state(self, inp: torch.Tensor) -> torch.Tensor:
        return self.encoder.init_hidden(inp)

    def get_motion_and_value(self, flow, corr, motion_hidden_state):
        """Motion features (128), new hidden state (64), value (128)."""
        motion, hidden = self.encoder(flow, corr, motion_hidden_state)
        return motion, hidden, self.aggregator(motion)

    def get_uncertainty(self, net_and_value: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.unc_conv2(F.relu(self.unc_conv1(net_and_value))))

    def get_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))

    def forward(self, net, inp, motion_features, motion_features_global,
                compute_mask: bool = False):
        """GRU update: returns (net, delta_flow), and with `compute_mask`
        (training, JAX's `compute_mask=collect_preds`) also the convex mask
        of the new state: (net, delta_flow, mask). Inference reads the mask
        once after the loop (`get_mask`)."""
        x = torch.cat([inp, motion_features, motion_features_global], dim=-1)
        if self.with_attention:
            x = self.space_attn(self.time_attn(x))
        net = self.gru(net, x)
        if compute_mask:
            return net, self.flow_head(net), self.get_mask(net)
        return net, self.flow_head(net)
