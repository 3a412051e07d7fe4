"""Reference state-dict key -> flax parameter path, for PPMStereo (the
port's copy of ppmstereo_tpu/utils/ppm_mapping.py; the tables are equal key
for key, tests/test_torch_import.py).

The flax path is the port's too: the port's modules carry the flax names,
so `utils/weights.py` loads what `cli/import_torch.py` writes with this
table. Covers the core graph (fnet, att, the three update blocks), the SST
and the ConvNeXt context net.
"""

from __future__ import annotations

import numpy as np

from ppmstereo_tpu_torch.utils.torch_import import convert_tensor


def _conv(tkey: str, fkey: str) -> dict[str, str]:
    return {f"{tkey}.weight": f"{fkey}/kernel", f"{tkey}.bias": f"{fkey}/bias"}


def _conv_nb(tkey: str, fkey: str) -> dict[str, str]:
    return {f"{tkey}.weight": f"{fkey}/kernel"}


def basic_encoder_mapping(t: str, f: str) -> dict[str, str]:
    """BasicEncoder (extractor.py:348-422) -> nn/encoder.py::BasicEncoder."""
    m = {}
    m.update(_conv(f"{t}.conv1", f"{f}/Conv_0/Conv_0"))
    blocks = [
        ("layer1.0", 0), ("layer1.1", 1), ("layer2.0", 2),
        ("layer2.1", 3), ("layer3.0", 4), ("layer3.1", 5),
    ]
    for tb, i in blocks:
        m.update(_conv(f"{t}.{tb}.conv1", f"{f}/ResidualBlock_{i}/Conv_0/Conv_0"))
        m.update(_conv(f"{t}.{tb}.conv2", f"{f}/ResidualBlock_{i}/Conv_1/Conv_0"))
        m.update(_conv(f"{t}.{tb}.downsample.0", f"{f}/ResidualBlock_{i}/Conv_2/Conv_0"))
    m.update(_conv(f"{t}.conv2", f"{f}/Conv_1/Conv_0"))
    return m


def pcblock_mapping(t: str, f: str) -> dict[str, str]:
    """PCBlock4_Deep_nopool_res (ppmtereo_update.py:91-115)."""
    m = {}
    m.update(_conv(f"{t}.ffn1.0", f"{f}/ffn1_a/Conv_0"))
    m.update(_conv(f"{t}.ffn1.2", f"{f}/ffn1_b/Conv_0"))
    m.update(_conv(f"{t}.conv_list.0", f"{f}/dws_0/Conv_0"))
    m.update(_conv(f"{t}.conv_list.1", f"{f}/dws_1/Conv_0"))
    m.update(_conv(f"{t}.pw", f"{f}/pw/Conv_0"))
    m.update(_conv(f"{t}.ffn2.0", f"{f}/ffn2_a/Conv_0"))
    m.update(_conv(f"{t}.ffn2.2", f"{f}/ffn2_b/Conv_0"))
    return m


def sk_gru3d_mapping(t: str, f: str) -> dict[str, str]:
    """SKSepConvGRU3D (ppmtereo_update.py:254-312)."""
    m = {}
    m.update(_conv(f"{t}.convz1.0", f"{f}/_SKConv_0/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.convz1.2", f"{f}/_SKConv_0/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.convr1.0", f"{f}/_SKConv_1/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.convr1.2", f"{f}/_SKConv_1/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.convq1", f"{f}/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.convz2", f"{f}/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.convr2", f"{f}/Conv_2/Conv_0"))
    m.update(_conv(f"{t}.convq2", f"{f}/Conv_3/Conv_0"))
    m.update(_conv(f"{t}.convz3", f"{f}/Conv_4/Conv_0"))
    m.update(_conv(f"{t}.convr3", f"{f}/Conv_5/Conv_0"))
    m.update(_conv(f"{t}.convq3", f"{f}/Conv_6/Conv_0"))
    return m


def sequence_update_block3d_mapping(
    t: str, f: str, with_init_conv: bool = True,
    attention_type: str | None = None,
) -> dict[str, str]:
    """SequenceUpdateBlock3D (ppmtereo_update.py:880-1003), convex-3D.

    init_conv only exists (and is only ever called) for the 1/16 block —
    the later stages inherit the motion hidden state (ppmstereo.py:726,
    763), so their init_conv weights are dead in the reference too.
    """
    m = {}
    m.update(pcblock_mapping(f"{t}.encoder.convc1", f"{f}/encoder/convc1"))
    for name in ("convc2", "convf1", "convf2", "final_conv"):
        m.update(_conv(f"{t}.encoder.{name}", f"{f}/encoder/{name}/Conv_0"))
    if with_init_conv:
        m.update(_conv(f"{t}.encoder.init_conv.0", f"{f}/encoder/init_conv1/Conv_0"))
        m.update(_conv(f"{t}.encoder.init_conv.2", f"{f}/encoder/init_conv2/Conv_0"))
    m.update(sk_gru3d_mapping(f"{t}.gru", f"{f}/gru"))
    m.update(_conv(f"{t}.flow_head.conv1", f"{f}/flow_head/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.flow_head.conv2", f"{f}/flow_head/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.uncertainty.0", f"{f}/unc_conv1/Conv_0"))
    m.update(_conv(f"{t}.uncertainty.2", f"{f}/unc_conv2/Conv_0"))
    m.update(_conv(f"{t}.mask_3d.0", f"{f}/mask_conv1/Conv_0"))
    m.update(_conv(f"{t}.mask_3d.2", f"{f}/mask_conv2/Conv_0"))
    m.update(_conv_nb(f"{t}.aggregator.to_v", f"{f}/aggregator/to_v/Conv_0"))
    m[f"{t}.aggregator.beta"] = f"{f}/aggregator/beta"
    at = attention_type or ""
    if "update_time" in at:
        m.update(time_attn_mapping(f"{t}.time_attn", f"{f}/time_attn"))
    if "update_space" in at:
        m.update(loftr_layer_mapping(
            f"{t}.space_attn.encoder_layer",
            f"{f}/space_attn/LoFTREncoderLayer_0",
        ))
    return m


def loftr_layer_mapping(t: str, f: str) -> dict[str, str]:
    m = {}
    for name in ("q_proj", "k_proj", "v_proj", "merge"):
        m[f"{t}.{name}.weight"] = f"{f}/{name}/kernel"
    m[f"{t}.mlp.0.weight"] = f"{f}/Dense_0/kernel"
    m[f"{t}.mlp.2.weight"] = f"{f}/Dense_1/kernel"
    m[f"{t}.norm1.weight"] = f"{f}/LayerNorm_0/scale"
    m[f"{t}.norm1.bias"] = f"{f}/LayerNorm_0/bias"
    m[f"{t}.norm2.weight"] = f"{f}/LayerNorm_1/scale"
    m[f"{t}.norm2.bias"] = f"{f}/LayerNorm_1/bias"
    return m


def time_attn_mapping(t: str, f: str) -> dict[str, str]:
    """TimeAttnBlock (ppmtereo_update.py:593-618)."""
    return {
        f"{t}.temporal_norm1.weight": f"{f}/LayerNorm_0/scale",
        f"{t}.temporal_norm1.bias": f"{f}/LayerNorm_0/bias",
        f"{t}.temporal_attn.proj.weight": f"{f}/proj/Dense_0/kernel",
        f"{t}.temporal_attn.proj.bias": f"{f}/proj/Dense_0/bias",
        f"{t}.temporal_fc.weight": f"{f}/temporal_fc/kernel",
        f"{t}.temporal_fc.bias": f"{f}/temporal_fc/bias",
    }


def sst_mapping(f: str = "sst", attention_type: str | None = None,
                depth: int = 4) -> dict[str, str]:
    at = attention_type or ""
    m = {}
    if "update_time" in at or "temporal" in at:
        m["time_embed"] = f"{f}/time_embed"
    if "temporal" in at:
        for i in range(depth):
            m.update(time_attn_mapping(f"time_attn_blocks.{i}", f"{f}/time_attn_blocks_{i}"))
    if "self_stereo" in at:
        for i in range(depth):
            m.update(loftr_layer_mapping(
                f"self_attn_blocks.{i}.layers.0", f"{f}/self_attn_blocks_{i}/layer_0"))
            m.update(loftr_layer_mapping(
                f"cross_attn_blocks.{i}.layers.0", f"{f}/cross_attn_blocks_{i}/layer_0"))
    return m


def convnext_mapping(t: str, f: str, depths=(3, 3, 9, 3)) -> dict[str, str]:
    """ConvNeXt-V2 backbone (reference convnext.py:81-143). The final
    norm/head exist in torch checkpoints but are unused by the context
    net (forward_features only) and have no flax counterpart."""
    m = {}
    m.update(_conv(f"{t}.downsample_layers.0.0", f"{f}/Conv_0"))
    m[f"{t}.downsample_layers.0.1.weight"] = f"{f}/LayerNorm_0/scale"
    m[f"{t}.downsample_layers.0.1.bias"] = f"{f}/LayerNorm_0/bias"
    for i in (1, 2, 3):
        m[f"{t}.downsample_layers.{i}.0.weight"] = f"{f}/LayerNorm_{i}/scale"
        m[f"{t}.downsample_layers.{i}.0.bias"] = f"{f}/LayerNorm_{i}/bias"
        m.update(_conv(f"{t}.downsample_layers.{i}.1", f"{f}/Conv_{i}"))
    blk = 0
    for si, depth in enumerate(depths):
        for bj in range(depth):
            tb = f"{t}.stages.{si}.{bj}"
            fb = f"{f}/ConvNeXtBlock_{blk}"
            m.update(_conv(f"{tb}.dwconv", f"{fb}/dwconv/Conv_0"))
            m[f"{tb}.norm.weight"] = f"{fb}/LayerNorm_0/scale"
            m[f"{tb}.norm.bias"] = f"{fb}/LayerNorm_0/bias"
            m[f"{tb}.pwconv1.weight"] = f"{fb}/Dense_0/kernel"
            m[f"{tb}.pwconv1.bias"] = f"{fb}/Dense_0/bias"
            m[f"{tb}.grn.gamma"] = f"{fb}/GRN_0/gamma"
            m[f"{tb}.grn.beta"] = f"{fb}/GRN_0/beta"
            m[f"{tb}.pwconv2.weight"] = f"{fb}/Dense_1/kernel"
            m[f"{tb}.pwconv2.bias"] = f"{fb}/Dense_1/bias"
            blk += 1
    return m


def contextnet_mapping(t: str = "cnet", f: str = "cnet") -> dict[str, str]:
    """ContextNet ('Feature', reference convnext.py:202-264)."""
    m = convnext_mapping(f"{t}.convnext", f"{f}/convnext")
    for scale in ("16", "8", "4"):
        m.update(_conv(f"{t}.upconv_{scale}.1", f"{f}/upconv_{scale}/Conv_0/Conv_0"))
        m.update(_conv(f"{t}.decode_{scale}x.0", f"{f}/decode_{scale}x/Conv_0/Conv_0"))
        m.update(_conv(f"{t}.decode_{scale}x.3", f"{f}/decode_{scale}x/Conv_1/Conv_0"))
    return m


# torch tensors with no flax counterpart by design (dead in the reference
# inference path too)
DEAD_REFERENCE_KEYS = (
    ".encoder.init_conv.",  # only the 1/16 block's init_conv ever runs
    "cnet.convnext.norm.",  # classification head, unused by Feature
    "cnet.convnext.head.",
    ".temporal_attn.qkv.",  # degenerate Attention never applies its qkv
)


def is_dead_reference_key(key: str, mapping: dict[str, str]) -> bool:
    if key in mapping:
        return False
    return any(tag in key for tag in DEAD_REFERENCE_KEYS)


def grn_transform(name: str, w):
    """The reference's GRN parameters are (1,1,1,C); flax keeps (C,)."""
    if ".grn." in name:
        return np.asarray(w).reshape(-1)
    return convert_tensor(name, w)


def ppmstereo_mapping(
    attention_type: str | None = None, use_cnet: bool = False
) -> dict[str, str]:
    """PPMStereo torch->flax mapping (full shipped config when
    attention_type and use_cnet are set)."""
    m = basic_encoder_mapping("fnet", "fnet")
    for i in range(3):
        m.update(_conv_nb(f"att.{i}.to_qk", f"att_{i}/to_qk/Conv_0"))
    for s in ("16", "08", "04"):
        m.update(
            sequence_update_block3d_mapping(
                f"update_block{s}", f"update_block{s}/update_block",
                with_init_conv=(s == "16"),
                # only the 1/16 block carries update-time/space attention
                # (reference ppmstereo.py:103-117)
                attention_type=attention_type if s == "16" else None,
            )
        )
    m.update(sst_mapping("sst", attention_type))
    if use_cnet:
        m.update(contextnet_mapping("cnet", "cnet"))
    return m
