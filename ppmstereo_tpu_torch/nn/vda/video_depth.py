"""Video-Depth-Anything and the adapters that feed its features to the
stereo models (counterpart of ppmstereo_tpu/nn/vda/video_depth.py):

  * `VideoDepthAnything.depth_features`: DINOv2's intermediate layers ->
    the DPT-temporal head -> (B, T, H, W, features // 2);
  * `VideoDepthAnything.fusion_features`: the head's four fusion maps,
    finest first (`features` channels each), the pyramid PPMStereo-VDA's
    `MultiLevelEncoderVFM` fuses;
  * `DepthExtractor` (StereoAnyVideo): resize to multiples of 14, the
    frozen features, resize back, a 4x4 stride-4 conv to 32 channels.

The backbone is frozen wherever it is used: its features are computed
without autograd.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ppmstereo_tpu_torch.nn.common import Conv
from ppmstereo_tpu_torch.nn.vda.dinov2 import DINOv2, embed_dim, intermediate_layer_idx
from ppmstereo_tpu_torch.nn.vda.dpt import DPTHeadTemporal
from ppmstereo_tpu_torch.ops.geometry import interp_ac_false

_MODEL_CONFIGS = {
    "vits": {"features": 64, "out_channels": (48, 96, 192, 384)},
    "vitl": {"features": 256, "out_channels": (256, 512, 1024, 1024)},
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VideoDepthAnything(nn.Module):
    """A window of up to 32 frames (the motion modules' position encoding)."""

    def __init__(self, encoder: str = "vits", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = _MODEL_CONFIGS[encoder]
        self.encoder = encoder
        self.pretrained = DINOv2(encoder, dtype=dtype)
        self.head = DPTHeadTemporal(embed_dim(encoder), cfg["features"], cfg["out_channels"],
                                    dtype=dtype)

    def _head(self, x: torch.Tensor, return_paths: bool):
        """x (B, T, H, W, 3), ImageNet-normalised, H and W multiples of 14."""
        b, t, h, w, _ = x.shape
        feats = self.pretrained.get_intermediate_layers(
            x.reshape(b * t, h, w, 3), intermediate_layer_idx(self.encoder))
        return self.head(feats, h // 14, w // 14, t, return_paths=return_paths)

    def depth_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, T, H, W, features // 2)."""
        out = self._head(x, False)
        return out.reshape(*x.shape[:2], *out.shape[1:])

    def fusion_features(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, T, H, W, 3) -> the 4 fusion maps (B, T, h_i, w_i, features),
        finest first."""
        _, paths = self._head(x, True)
        return tuple(p.reshape(*x.shape[:2], *p.shape[1:]) for p in paths)


class DepthExtractor(nn.Module):
    """The frozen VDA features at 1/4 resolution, 32 channels."""

    def __init__(self, encoder: str = "vits", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthanything = VideoDepthAnything(encoder, dtype=dtype)
        self.conv = Conv(_MODEL_CONFIGS[encoder]["features"] // 2, 32, (4, 4), stride=4,
                         padding=(0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3), ImageNet-normalised -> (B, T, H/4, W/4, 32)."""
        h, w = x.shape[2], x.shape[3]
        with torch.no_grad():
            feats = self.depthanything.depth_features(
                interp_ac_false_to(x, ((h // 14) * 14, (w // 14) * 14)))
        return self.conv(interp_ac_false_to(feats, (h, w)))


def interp_ac_false_to(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=False resize of (..., H, W, C) to `hw` (torch
    F.interpolate's default)."""
    return interp_ac_false(x, hw)


def imagenet_normalize(images_0_255: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 255] -> ImageNet-normalised, in f32."""
    x = images_0_255.float()
    mean = torch.tensor(IMAGENET_MEAN, device=x.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=x.device) * 255.0
    return (x - mean) / std
