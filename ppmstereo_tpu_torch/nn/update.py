"""Sequence update blocks: the recurrent refinement cells of PPMStereo,
StereoAnyVideo and DynamicStereo (counterpart of
ppmstereo_tpu/nn/update.py::FlowHead, Aggregate, SequenceUpdateBlock3D,
SAVSequenceUpdateBlock3D, DSSequenceUpdateBlock3D). Tensors are
(B, T, H, W, C).

FlowHead and PPMStereo's SequenceUpdateBlock3D also run on one rank's
frames of a window spread over the seq axis (`shard`, a
`parallel/sharding.py::FrameShard`): each 3x3x3 convolution exchanges a
halo of one frame, and the 1/16 stage's time attention runs on the
gathered window."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.attention import SpaceAttnBlock, TimeAttnBlock
from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.gru import SepConvGRU3D, SKSepConvGRU3D
from ppmstereo_tpu_torch.nn.motion import BasicMotionEncoder, BasicMotionEncoderV2

MOTION_DIM = 128  # the motion features (126 + the 2-channel flow) and the value
GRU_ATTN_DIM = 384  # the update attention's width, fixed as in the JAX package


class FlowHead(nn.Module):
    """Two 3x3x3 convs (in_dim -> 256 -> 2) -> delta flow."""

    def __init__(self, in_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_dim, 256, (3, 3, 3), dtype=dtype)
        self.Conv_1 = Conv(256, 2, (3, 3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return self.Conv_1.time_sharded(F.relu(self.Conv_0.time_sharded(x, shard)), shard)


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
    mask head of the convex upsample by 4: 27 taps x 4 x 4 channels from a
    3x3x3 conv (`use_convex_3d`), else 9 x 4 x 4 from a 3x3 one.

    hidden_dim is the GRU state's width, cor_planes the lookup's channels
    (levels x (2 radius + 1)), inp_dim the context input's width (the
    features' `dim - hidden_dim`). The GRU reads cat[context, motion, play
    output], inp_dim + 256 wide. Before it, the first stage's cell attends
    over time (`"update_time"` in attention_type) and space
    (`"update_space"`), 384 wide as in the JAX package, and bootstraps the
    motion hidden state from the context (`with_init_hidden`)."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 36, inp_dim: int = 128,
                 use_convex_3d: bool = True, attention_type: str | None = None,
                 with_init_hidden: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, m = hidden_dim, MOTION_DIM
        self.encoder = BasicMotionEncoderV2(cor_planes, inp_dim, with_init_hidden, dtype)
        self.gru = SKSepConvGRU3D(d, inp_dim + 2 * m, dtype)
        self.flow_head = FlowHead(d, dtype)
        self.unc_conv1 = Conv(d + m, d, (3, 3), dtype=dtype)
        self.unc_conv2 = Conv(d, 1, (1, 1), padding=(0, 0), dtype=dtype)
        taps, kernel = (27, (3, 3, 3)) if use_convex_3d else (9, (3, 3))
        self.mask_conv1 = Conv(d, d + m, kernel, dtype=dtype)
        self.mask_conv2 = Conv(d + m, taps * 4 * 4, (1,) * len(kernel),
                               padding=(0,) * len(kernel), dtype=dtype)
        at = attention_type or ""
        self.with_time_attn = "update_time" in at
        self.with_space_attn = "update_space" in at
        if self.with_time_attn:
            self.time_attn = TimeAttnBlock(GRU_ATTN_DIM, 8, dtype)
        if self.with_space_attn:
            self.space_attn = SpaceAttnBlock(GRU_ATTN_DIM, 8, dtype)
        self.aggregator = Aggregate(m, dtype)

    def init_motion_hidden_state(self, inp: torch.Tensor) -> torch.Tensor:
        return self.encoder.init_hidden(inp)

    def get_motion_and_value(self, flow, corr, motion_hidden_state):
        """Motion features (128), new hidden state (64), value (128)."""
        motion, hidden = self.encoder(flow, corr, motion_hidden_state)
        return motion, hidden, self.aggregator(motion)

    def get_uncertainty(self, net_and_value: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.unc_conv2(F.relu(self.unc_conv1(net_and_value))))

    def get_mask(self, net: torch.Tensor, shard=None) -> torch.Tensor:
        conv = self.mask_conv1
        y = conv.time_sharded(net, shard) if conv.Conv_0.nd == 3 else conv(net)
        return 0.25 * self.mask_conv2(F.relu(y))

    def forward(self, net, inp, motion_features, motion_features_global,
                compute_mask: bool = False, shard=None):
        """GRU update: returns (net, delta_flow), and with `compute_mask`
        (training, JAX's `compute_mask=collect_preds`) also the convex mask
        of the new state: (net, delta_flow, mask). Inference reads the mask
        once after the loop (`get_mask`). shard: this rank's frames of a
        window over the seq axis (None: the whole window)."""
        x = torch.cat([inp, motion_features, motion_features_global], dim=-1)
        if self.with_time_attn:
            x = self.time_attn(x, shard)
        if self.with_space_attn:
            x = self.space_attn(x)
        net = self.gru(net, x, shard)
        if compute_mask:
            return net, self.flow_head(net, shard), self.get_mask(net, shard)
        return net, self.flow_head(net, shard)


class SAVSequenceUpdateBlock3D(nn.Module):
    """StereoAnyVideo's update cell: an all-relu motion encoder (its convs
    live on the block), time and space attention on the GRU input (256
    wide, always on), SKSepConvGRU3D, the 3x3x3 flow head and the 3-D mask
    head of the convex upsample by 4 (27 x 4 x 4 channels).

    The GRU reads cat[context (hidden_dim wide), motion (126 + the flow)]."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, m = hidden_dim, MOTION_DIM
        self.convc1 = Conv(cor_planes, 256, (1, 1), padding=(0, 0), dtype=dtype)
        self.convc2 = Conv(256, 192, (3, 3), dtype=dtype)
        self.convf1 = Conv(2, 128, (7, 7), dtype=dtype)
        self.convf2 = Conv(128, 64, (3, 3), dtype=dtype)
        self.conv = Conv(192 + 64, m - 2, (3, 3), dtype=dtype)
        self.gru = SKSepConvGRU3D(d, d + m, dtype)
        self.flow_head = FlowHead(d, dtype)
        self.mask_conv1 = Conv(d, d + m, (3, 3, 3), dtype=dtype)
        self.mask_conv2 = Conv(d + m, 27 * 4 * 4, (1, 1, 1), padding=(0, 0, 0), dtype=dtype)
        self.time_attn = TimeAttnBlock(d + m, 8, dtype)
        self.space_attn = SpaceAttnBlock(d + m, 8, dtype)

    def get_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))

    def forward(self, net, inp, corrs, flow, compute_mask: bool = False):
        """Returns (net, delta_flow), and with `compute_mask` (train mode)
        also the mask of the new state: (net, delta_flow, mask)."""
        cor = F.relu(self.convc2(F.relu(self.convc1(corrs))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        motion = F.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        x = torch.cat([inp, motion, flow], dim=-1)
        x = self.space_attn(self.time_attn(x))
        net = self.gru(net, x)
        if compute_mask:
            return net, self.flow_head(net), self.get_mask(net)
        return net, self.flow_head(net)


class DSSequenceUpdateBlock3D(nn.Module):
    """DynamicStereo's update cell: BasicMotionEncoder (ReLU after its first
    corr conv), the plain SepConvGRU3D, the 3x3x3 flow head and the 2-D mask
    head of the convex upsample by 4 (9 x 4 x 4 channels from a 3x3 conv).

    The GRU reads cat[context (hidden_dim wide), motion (128)]. Before it,
    the cell attends over time (`"update_time"` in attention_type) and space
    (`"update_space"`), 256 wide; DynamicStereo names them for its 1/16
    stage only."""

    def __init__(self, hidden_dim: int = 128, cor_planes: int = 36,
                 attention_type: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, m = hidden_dim, MOTION_DIM
        self.encoder = BasicMotionEncoder(cor_planes, "relu", dtype)
        self.gru = SepConvGRU3D(d, d + m, dtype)
        self.flow_head = FlowHead(d, dtype)
        self.mask_conv1 = Conv(d, d + m, (3, 3), dtype=dtype)
        self.mask_conv2 = Conv(d + m, 9 * 4 * 4, (1, 1), padding=(0, 0), dtype=dtype)
        at = attention_type or ""
        self.with_time_attn = "update_time" in at
        self.with_space_attn = "update_space" in at
        if self.with_time_attn:
            self.time_attn = TimeAttnBlock(d + m, 8, dtype)
        if self.with_space_attn:
            self.space_attn = SpaceAttnBlock(d + m, 8, dtype)

    def get_mask(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))

    def forward(self, net, inp, corrs, flow, compute_mask: bool = False):
        """Returns (net, delta_flow), and with `compute_mask` (train mode)
        also the mask of the new state: (net, delta_flow, mask)."""
        x = torch.cat([inp, self.encoder(flow, corrs)], dim=-1)
        if self.with_time_attn:
            x = self.time_attn(x)
        if self.with_space_attn:
            x = self.space_attn(x)
        net = self.gru(net, x)
        if compute_mask:
            return net, self.flow_head(net), self.get_mask(net)
        return net, self.flow_head(net)
