"""DPT decoder head with temporal motion modules (counterpart of
ppmstereo_tpu/nn/vda/dpt.py), channels-last.

Per-layer 1x1 projections; the resize stack (a 4x4 stride-4 transposed
convolution, a 2x2 stride-2 one, identity, a 3x3 stride-2 convolution);
3x3 `layer*_rn` convolutions; the fusion blocks (two residual conv units,
a bilinear align-corners resize, a 1x1 conv), with motion modules on
layers 3 and 4 and after fusion blocks 4 and 3. The output is output_conv1
resized to (ph*14, pw*14), `features // 2` channels; `return_paths` also
gives the four fusion maps, finest first.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.vda.motion import TemporalModule
from ppmstereo_tpu_torch.ops.geometry import interp_bilinear


class ConvTranspose(nn.ConvTranspose2d):
    """A transposed convolution with stride = kernel (flax `nn.ConvTranspose`,
    padding VALID) on channels-last (..., H, W, C), computing in `dtype`.
    The weight is torch's (in, out, kh, kw); the carry from flax's (kh, kw,
    in, out) kernel flips it in space (`utils/weights.py`)."""

    def __init__(self, in_features: int, features: int, kernel: tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, kernel, stride=kernel)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).movedim(-1, 1)
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               self.bias.to(self.dtype), self.stride)
        y = y.movedim(1, -1)
        return y.reshape(*lead, *y.shape[1:])


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(features, features, (3, 3), dtype=dtype)
        self.conv2 = Conv(features, features, (3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """`with_res`: the block takes a skip input (all but refinenet4)."""

    def __init__(self, features: int, with_res: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if with_res:
            self.res1 = ResidualConvUnit(features, dtype)
        self.res2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv(features, features, (1, 1), padding=(0, 0), dtype=dtype)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.res1(res)
        x = self.res2(x)
        if size is None:
            size = (2 * x.shape[-3], 2 * x.shape[-2])
        return self.out_conv(interp_bilinear(x, size))


class DPTHeadTemporal(nn.Module):
    """out_features: 4 (patch tokens (N, ph*pw, D), class token) of N = B*T
    frames; the motion modules fold them back into videos of `t` frames."""

    def __init__(self, in_channels: int, features: int = 64,
                 out_channels: tuple = (48, 96, 192, 384), num_frames: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        oc, f = out_channels, features
        for i in range(4):
            self.add_module(f"project_{i}", Conv(in_channels, oc[i], (1, 1), padding=(0, 0),
                                                 dtype=dtype))
        self.resize_0 = ConvTranspose(oc[0], oc[0], (4, 4), dtype)
        self.resize_1 = ConvTranspose(oc[1], oc[1], (2, 2), dtype)
        self.resize_3 = Conv(oc[3], oc[3], (3, 3), stride=2, dtype=dtype)
        mm = dict(num_heads=8, num_transformer_block=1, num_attention_blocks=2,
                  temporal_max_len=num_frames, dtype=dtype)
        self.motion_0 = TemporalModule(oc[2], **mm)
        self.motion_1 = TemporalModule(oc[3], **mm)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", Conv(oc[i], f, (3, 3), use_bias=False,
                                                     dtype=dtype))
        for j in range(1, 5):
            self.add_module(f"refinenet{j}", FeatureFusionBlock(f, j != 4, dtype))
        self.motion_2 = TemporalModule(f, **mm)
        self.motion_3 = TemporalModule(f, **mm)
        self.output_conv1 = Conv(f, f // 2, (3, 3), dtype=dtype)

    def forward(self, out_features, patch_h: int, patch_w: int, t: int,
                return_paths: bool = False):
        resize = {0: self.resize_0, 1: self.resize_1, 3: self.resize_3}
        layers = []
        for i, (tokens, _cls) in enumerate(out_features):
            x = tokens.reshape(tokens.shape[0], patch_h, patch_w, -1)
            x = getattr(self, f"project_{i}")(x)
            layers.append(resize[i](x) if i in resize else x)

        def temporal(module, x):  # frames -> a video of t frames and back
            y = module(x.reshape(x.shape[0] // t, t, *x.shape[1:]))
            return y.reshape(x.shape)

        layers[2] = temporal(self.motion_0, layers[2])
        layers[3] = temporal(self.motion_1, layers[3])
        rn = [getattr(self, f"layer{i + 1}_rn")(x) for i, x in enumerate(layers)]
        path4 = self.refinenet4(rn[3], size=rn[2].shape[-3:-1])
        path4 = temporal(self.motion_2, path4)
        path3 = self.refinenet3(path4, rn[2], size=rn[1].shape[-3:-1])
        path3 = temporal(self.motion_3, path3)
        path2 = self.refinenet2(path3, rn[1], size=rn[0].shape[-3:-1])
        path1 = self.refinenet1(path2, rn[0])
        out = interp_bilinear(self.output_conv1(path1), (patch_h * 14, patch_w * 14))
        if return_paths:
            return out, (path1, path2, path3, path4)
        return out
