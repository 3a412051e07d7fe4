"""Reference state-dict key -> flax parameter path for Video-Depth-Anything
(DINOv2 ViT, the DPT-temporal head, the AnimateDiff motion modules): the
port's copy of ppmstereo_tpu/utils/vda_mapping.py, equal key for key
(tests/test_torch_import.py). It lets the frozen VDA backbone of
StereoAnyVideo and PPMStereo-VDA load pretrained reference checkpoints.
"""

from __future__ import annotations

import numpy as np

from ppmstereo_tpu_torch.utils.torch_import import convert_tensor, deconv2d_w

_DEPTHS = {"vits": 12, "vitl": 24}


def _ln(t: str, f: str) -> dict[str, str]:
    return {f"{t}.weight": f"{f}/scale", f"{t}.bias": f"{f}/bias"}


def _dense(t: str, f: str) -> dict[str, str]:
    return {f"{t}.weight": f"{f}/kernel", f"{t}.bias": f"{f}/bias"}


def _conv(t: str, f: str) -> dict[str, str]:
    return {f"{t}.weight": f"{f}/kernel", f"{t}.bias": f"{f}/bias"}


def dinov2_mapping(t: str, f: str, encoder: str = "vits") -> dict[str, str]:
    """DINOv2 ViT (reference dinov2.py:44-415, dinov2_layers/)."""
    m = {
        f"{t}.cls_token": f"{f}/cls_token",
        f"{t}.pos_embed": f"{f}/pos_embed",
    }
    m.update(_conv(f"{t}.patch_embed.proj", f"{f}/patch_embed"))
    for i in range(_DEPTHS[encoder]):
        tb, fb = f"{t}.blocks.{i}", f"{f}/block_{i}"
        m.update(_ln(f"{tb}.norm1", f"{fb}/LayerNorm_0"))
        m.update(_dense(f"{tb}.attn.qkv", f"{fb}/attn/qkv"))
        m.update(_dense(f"{tb}.attn.proj", f"{fb}/attn/proj"))
        m[f"{tb}.ls1.gamma"] = f"{fb}/ls1/gamma"
        m.update(_ln(f"{tb}.norm2", f"{fb}/LayerNorm_1"))
        m.update(_dense(f"{tb}.mlp.fc1", f"{fb}/Dense_0"))
        m.update(_dense(f"{tb}.mlp.fc2", f"{fb}/Dense_1"))
        m[f"{tb}.ls2.gamma"] = f"{fb}/ls2/gamma"
    m.update(_ln(f"{t}.norm", f"{f}/norm"))
    return m


def temporal_module_mapping(t: str, f: str) -> dict[str, str]:
    """AnimateDiff TemporalModule (motion_module/motion_module.py:31-177).
    One transformer block, two attention blocks (the shipped config,
    dpt_temporal.py:35-41)."""
    tt = f"{t}.temporal_transformer"
    m = {
        f"{tt}.norm.weight": f"{f}/GroupNorm_0/scale",
        f"{tt}.norm.bias": f"{f}/GroupNorm_0/bias",
    }
    m.update(_dense(f"{tt}.proj_in", f"{f}/proj_in"))
    tb, fb = f"{tt}.transformer_blocks.0", f"{f}/block_0"
    for a in range(2):
        ta, fa = f"{tb}.attention_blocks.{a}", f"{fb}/attn_{a}"
        for name in ("to_q", "to_k", "to_v"):
            m[f"{ta}.{name}.weight"] = f"{fa}/{name}/kernel"
        m.update(_dense(f"{ta}.to_out.0", f"{fa}/to_out"))
        m.update(_ln(f"{tb}.norms.{a}", f"{fb}/LayerNorm_{a}"))
    m.update(_dense(f"{tb}.ff.net.0.proj", f"{fb}/GEGLUFeedForward_0/Dense_0"))
    m.update(_dense(f"{tb}.ff.net.2", f"{fb}/GEGLUFeedForward_0/Dense_1"))
    m.update(_ln(f"{tb}.ff_norm", f"{fb}/LayerNorm_2"))
    m.update(_dense(f"{tt}.proj_out", f"{f}/proj_out"))
    return m


def dpt_head_mapping(t: str, f: str) -> dict[str, str]:
    """DPTHeadTemporal (reference dpt.py:47-159 + dpt_temporal.py:22-96)."""
    m = {}
    for i in range(4):
        m.update(_conv(f"{t}.projects.{i}", f"{f}/project_{i}/Conv_0"))
    m.update(_conv(f"{t}.resize_layers.0", f"{f}/resize_0"))
    m.update(_conv(f"{t}.resize_layers.1", f"{f}/resize_1"))
    m.update(_conv(f"{t}.resize_layers.3", f"{f}/resize_3/Conv_0"))
    for i in range(1, 5):
        m[f"{t}.scratch.layer{i}_rn.weight"] = f"{f}/layer{i}_rn/Conv_0/kernel"
    for j in range(1, 5):
        tb, fb = f"{t}.scratch.refinenet{j}", f"{f}/refinenet{j}"
        if j != 4:  # refinenet4 is called with a single input: its
            # resConfUnit1 is dead in the reference too (dpt_temporal.py:83)
            m.update(_conv(f"{tb}.resConfUnit1.conv1", f"{fb}/res1/conv1/Conv_0"))
            m.update(_conv(f"{tb}.resConfUnit1.conv2", f"{fb}/res1/conv2/Conv_0"))
        m.update(_conv(f"{tb}.resConfUnit2.conv1", f"{fb}/res2/conv1/Conv_0"))
        m.update(_conv(f"{tb}.resConfUnit2.conv2", f"{fb}/res2/conv2/Conv_0"))
        m.update(_conv(f"{tb}.out_conv", f"{fb}/out_conv/Conv_0"))
    m.update(_conv(f"{t}.scratch.output_conv1", f"{f}/output_conv1/Conv_0"))
    for i in range(4):
        m.update(temporal_module_mapping(f"{t}.motion_modules.{i}", f"{f}/motion_{i}"))
    return m


def vda_mapping(t: str = "", f: str = "", encoder: str = "vits") -> dict[str, str]:
    """Full VideoDepthAnything (video_depth.py:37-72)."""
    tp = f"{t}." if t else ""
    fp = f"{f}/" if f else ""
    m = dinov2_mapping(f"{tp}pretrained", f"{fp}pretrained", encoder)
    m.update(dpt_head_mapping(f"{tp}head", f"{fp}head"))
    return m


VDA_DEAD_KEY_TAGS = (
    "mask_token",  # masking path unused at inference (dinov2.py:215-216)
    "pos_encoder.pe",  # deterministic sinusoidal buffer, recomputed
    "output_conv2",  # scalar depth head, commented out (dpt_temporal.py:96)
    "refinenet4.resConfUnit1",  # dead: refinenet4 gets one input
)


def is_vda_dead_key(key: str, mapping: dict[str, str]) -> bool:
    if key in mapping:
        return False
    return any(tag in key for tag in VDA_DEAD_KEY_TAGS)


def is_transposed_conv_key(name: str) -> bool:
    """The DPT head's two transposed convolutions (torch ConvTranspose2d)."""
    return ".resize_layers.0." in name or ".resize_layers.1." in name


def vda_transform(name: str, w: np.ndarray) -> np.ndarray:
    """convert_tensor, with the ConvTranspose case: torch (I, O, kh, kw) ->
    flax ConvTranspose (kh, kw, I, O), flipped in space."""
    if is_transposed_conv_key(name) and w.ndim == 4:
        return deconv2d_w(w)
    return convert_tensor(name, w)
