"""Motion encoders and the context q/k projector on (B, T, H, W, C)
(counterpart of ppmstereo_tpu/nn/motion.py::PCBlock, AttentionQK,
BasicMotionEncoder, BasicMotionEncoderV2, SKMotionEncoder). 2-D convs fold
(B, T) into the batch."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv


class PCBlock(nn.Module):
    """Depthwise-conv and FFN residual block: one depthwise conv of each
    kernel size in `k_conv` (1 and 7 in the motion encoder's `convc1`) and a
    hidden width of 1.5 c_in."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype = torch.float32,
                 k_conv: tuple = (1, 7)):
        super().__init__()
        hid = int(1.5 * c_in)
        self.k_conv = tuple(k_conv)
        self.ffn1_a = Conv(c_in, hid, (1, 1), padding=(0, 0), dtype=dtype)
        self.ffn1_b = Conv(hid, c_in, (1, 1), padding=(0, 0), dtype=dtype)
        for i, k in enumerate(self.k_conv):
            self.add_module(f"dws_{i}", Conv(c_in, c_in, (k, k), groups=c_in, dtype=dtype))
        self.pw = Conv(c_in, c_in, (1, 1), padding=(0, 0), dtype=dtype)
        self.ffn2_a = Conv(c_in, hid, (1, 1), padding=(0, 0), dtype=dtype)
        self.ffn2_b = Conv(hid, c_out, (1, 1), padding=(0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(x + self.ffn1_b(F.gelu(self.ffn1_a(x))))
        for i in range(len(self.k_conv)):
            x = F.gelu(x + getattr(self, f"dws_{i}")(x))
        x = F.gelu(x + self.pw(x))
        return self.ffn2_b(F.gelu(self.ffn2_a(x)))


class AttentionQK(nn.Module):
    """1x1 conv producing (query, key) from context features."""

    def __init__(self, in_dim: int = 128, dim_head: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = Conv(in_dim, 2 * dim_head, (1, 1), padding=(0, 0),
                          use_bias=False, dtype=dtype)

    def forward(self, fmap: torch.Tensor):
        qk = self.to_qk(fmap)
        return qk[..., : self.dim_head], qk[..., self.dim_head:]


class BasicMotionEncoder(nn.Module):
    """corr + flow -> 128-ch motion features (126 + the flow), convs
    `Conv_0` .. `Conv_4` in the JAX module's order. corr_act: GELU after the
    first corr conv in the PPM variant, ReLU in DynamicStereo's
    (ppmstereo_tpu/nn/motion.py:66-69)."""

    def __init__(self, cor_planes: int = 36, corr_act: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if corr_act not in ("gelu", "relu"):
            raise ValueError(f"corr_act {corr_act!r}: gelu or relu")
        self.corr_act = F.gelu if corr_act == "gelu" else F.relu
        self.Conv_0 = Conv(cor_planes, 256, (1, 1), padding=(0, 0), dtype=dtype)
        self.Conv_1 = Conv(256, 192, (3, 3), dtype=dtype)
        self.Conv_2 = Conv(2, 128, (7, 7), dtype=dtype)
        self.Conv_3 = Conv(128, 64, (3, 3), dtype=dtype)
        self.Conv_4 = Conv(192 + 64, 126, (3, 3), dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.Conv_1(self.corr_act(self.Conv_0(corr))))
        flo = F.relu(self.Conv_3(F.relu(self.Conv_2(flow))))
        out = F.relu(self.Conv_4(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


class BasicMotionEncoderV2(nn.Module):
    """corr + flow -> 128-ch motion features, with a recurrent 64-ch motion
    hidden state. Only the first stage's encoder bootstraps that state from
    context features (`init_hidden`), so only it owns `init_conv1/2`."""

    def __init__(self, cor_planes: int = 36, context_dim: int = 128,
                 with_init_hidden: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convc1 = PCBlock(cor_planes, 256, dtype)
        self.convc2 = Conv(256, 192, (3, 3), dtype=dtype)
        self.convf1 = Conv(2, 128, (7, 7), dtype=dtype)
        self.convf2 = Conv(128, 64, (3, 3), dtype=dtype)
        self.final_conv = Conv(192 + 64 + 64, 126 + 64, (3, 3), dtype=dtype)
        if with_init_hidden:
            self.init_conv1 = Conv(context_dim, 64, (3, 3), dtype=dtype)
            self.init_conv2 = Conv(64, 64, (3, 3), dtype=dtype)

    def init_hidden(self, inp: torch.Tensor) -> torch.Tensor:
        return self.init_conv2(F.relu(self.init_conv1(inp)))

    def forward(self, flow, corr, motion_hidden_state):
        cor = F.gelu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.final_conv(torch.cat([cor, flo, motion_hidden_state], dim=-1)))
        motion, hidden = out[..., :126], out[..., 126:]
        return torch.cat([motion, flow], dim=-1), hidden


class SKMotionEncoder(nn.Module):
    """SKFlow-style motion encoder of PCBlocks: corr (cor_planes) and flow
    (2 channels) -> 128-ch motion features (126 + the flow). No model calls
    it."""

    def __init__(self, cor_planes: int, k_conv: tuple = (1, 15),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convc1 = PCBlock(cor_planes, 256, dtype, k_conv)
        self.convc2 = PCBlock(256, 192, dtype, k_conv)
        self.convf1 = Conv(2, 128, (1, 1), padding=(0, 0), dtype=dtype)
        self.convf2 = PCBlock(128, 64, dtype, k_conv)
        self.conv = PCBlock(64 + 192, 126, dtype, k_conv)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = self.convc2(F.gelu(self.convc1(corr)))
        flo = self.convf2(self.convf1(flow))
        out = self.conv(torch.cat([cor, flo], dim=-1))
        return torch.cat([out, flow], dim=-1)
