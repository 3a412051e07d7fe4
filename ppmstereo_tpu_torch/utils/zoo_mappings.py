"""Reference state-dict key -> flax parameter path, for the zoo's other
families: DynamicStereo, BiDAStereo with RAFT, RAFT, RAFT-Stereo,
StereoAnyVideo and PPMStereo-VDA (the port's copy of
ppmstereo_tpu/utils/zoo_mappings.py; the tables are equal key for key,
tests/test_torch_import.py).

Same contract as utils/ppm_mapping.py: every live reference tensor appears
as a key, so a trained reference checkpoint imports losslessly; the keys
are the reference's module names (princeton-vl RAFT and RAFT-Stereo naming
for those two).
"""

from __future__ import annotations

from ppmstereo_tpu_torch.utils.ppm_mapping import (
    _conv,
    basic_encoder_mapping,
    loftr_layer_mapping,
    sk_gru3d_mapping,
    sst_mapping,
    time_attn_mapping,
)

DS_ATTENTION = "self_stereo_temporal_update_time_update_space"


def sep_gru3d_mapping(t: str, f: str) -> dict[str, str]:
    """Plain SepConvGRU3D (reference update.py:158-189): 9 convs in
    z/r/q order per (width, height, time) pass -> compact Conv_0..8."""
    order = (
        "convz1", "convr1", "convq1",
        "convz2", "convr2", "convq2",
        "convz3", "convr3", "convq3",
    )
    m = {}
    for i, name in enumerate(order):
        m.update(_conv(f"{t}.{name}", f"{f}/Conv_{i}/Conv_0"))
    return m


def sep_gru2d_mapping(t: str, f: str) -> dict[str, str]:
    """SepConvGRU (reference update.py:31-69): 6 convs, z/r/q per
    (horizontal, vertical) pass."""
    order = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
    m = {}
    for i, name in enumerate(order):
        m.update(_conv(f"{t}.{name}", f"{f}/Conv_{i}/Conv_0"))
    return m


def basic_motion_encoder_mapping(t: str, f: str) -> dict[str, str]:
    """BasicMotionEncoder (reference update.py:216-234), compact-built
    Conv_0..4 in declaration order."""
    m = {}
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        m.update(_conv(f"{t}.{name}", f"{f}/Conv_{i}/Conv_0"))
    return m


def ds_update_block_mapping(
    t: str, f: str, attention_type: str | None = None
) -> dict[str, str]:
    """DynamicStereo SequenceUpdateBlock3D (reference update.py:481-525)
    -> nn/update.py::DSSequenceUpdateBlock3D."""
    m = basic_motion_encoder_mapping(f"{t}.encoder", f"{f}/encoder")
    m.update(sep_gru3d_mapping(f"{t}.gru", f"{f}/gru"))
    m.update(_conv(f"{t}.flow_head.conv1", f"{f}/flow_head/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.flow_head.conv2", f"{f}/flow_head/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.mask.0", f"{f}/mask_conv1/Conv_0"))
    m.update(_conv(f"{t}.mask.2", f"{f}/mask_conv2/Conv_0"))
    at = attention_type or ""
    if "update_time" in at:
        m.update(time_attn_mapping(f"{t}.time_attn", f"{f}/time_attn"))
    if "update_space" in at:
        m.update(loftr_layer_mapping(
            f"{t}.space_attn.encoder_layer", f"{f}/space_attn/LoFTREncoderLayer_0"
        ))
    return m


def dynamicstereo_mapping(attention_type: str | None = DS_ATTENTION) -> dict[str, str]:
    """DynamicStereo (reference dynamic_stereo.py:33-135; shipped config
    models/dynamic_stereo_model.py:27-34)."""
    m = basic_encoder_mapping("fnet", "fnet")
    m.update(sst_mapping("sst", attention_type))
    for s in ("16", "08", "04"):
        m.update(ds_update_block_mapping(
            f"update_block{s}", f"update_block{s}/update_block",
            # only the 1/16 block carries update-time/space attention
            # (reference dynamic_stereo.py:67-78)
            attention_type if s == "16" else None,
        ))
    return m


def multi_motion_encoder_mapping(t: str, f: str) -> dict[str, str]:
    """BiDA MultiMotionEncoder (reference bidastereo_update.py:85-157)."""
    m = {}
    m.update(_conv(f"{t}.convc1", f"{f}/convc1/Conv_0"))
    m.update(_conv(f"{t}.convc2", f"{f}/convc2/Conv_0"))
    m.update(_conv(f"{t}.convf1", f"{f}/convf1/Conv_0"))
    m.update(_conv(f"{t}.convf2", f"{f}/convf2/Conv_0"))
    m.update(_conv(f"{t}.conv", f"{f}/final_conv/Conv_0"))
    m[f"{t}.init_hidden_state"] = f"{f}/init_hidden_state"
    return m


def bidastereo_mapping(include_raft: bool = True) -> dict[str, str]:
    """BiDAStereo (reference bidastereo.py:23-37): fnet + single shared
    MultiSequenceUpdateBlock3D (+ frozen RAFT flow provider)."""
    m = basic_encoder_mapping("fnet", "fnet")
    t, f = "update_block", "update_block"
    m.update(multi_motion_encoder_mapping(f"{t}.encoder", f"{f}/encoder"))
    m.update(sk_gru3d_mapping(f"{t}.gru", f"{f}/gru"))
    m.update(_conv(f"{t}.flow_head.conv1", f"{f}/flow_head/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.flow_head.conv2", f"{f}/flow_head/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.mask.0", f"{f}/mask_conv1/Conv_0"))
    m.update(_conv(f"{t}.mask.2", f"{f}/mask_conv2/Conv_0"))
    if include_raft:
        m.update(raft_mapping("raft.model", "raft/raft"))
    return m


def _frozen_bn(t: str, f: str) -> dict[str, str]:
    return {
        f"{t}.weight": f"{f}/scale",
        f"{t}.bias": f"{f}/bias",
        f"{t}.running_mean": f"{f}/mean",
        f"{t}.running_var": f"{f}/var",
    }


def _raft_encoder_mapping(t: str, f: str, norm: str) -> dict[str, str]:
    """princeton-vl RAFT BasicEncoder -> models/raft.py::RAFTEncoder
    (explicit torch-mirroring module names). Instance norm carries no
    params; batch norm maps running stats onto FrozenBatchNorm. The
    downsample path (and norm3) only exists at stride-2 first blocks
    (layer2.0, layer3.0)."""
    m = {}
    m.update(_conv(f"{t}.conv1", f"{f}/conv1/Conv_0"))
    if norm == "batch":
        m.update(_frozen_bn(f"{t}.norm1", f"{f}/norm1"))
    for li in (1, 2, 3):
        for bj in (0, 1):
            tb, fb = f"{t}.layer{li}.{bj}", f"{f}/layer{li}_{bj}"
            m.update(_conv(f"{tb}.conv1", f"{fb}/conv1/Conv_0"))
            m.update(_conv(f"{tb}.conv2", f"{fb}/conv2/Conv_0"))
            if norm == "batch":
                m.update(_frozen_bn(f"{tb}.norm1", f"{fb}/norm1"))
                m.update(_frozen_bn(f"{tb}.norm2", f"{fb}/norm2"))
            if li > 1 and bj == 0:  # stride-2 entry block
                m.update(_conv(f"{tb}.downsample.0", f"{fb}/downsample/Conv_0"))
                if norm == "batch":
                    m.update(_frozen_bn(f"{tb}.norm3", f"{fb}/norm3"))
                    m.update(_frozen_bn(f"{tb}.downsample.1", f"{fb}/norm3"))
    m.update(_conv(f"{t}.conv2", f"{f}/conv2/Conv_0"))
    return m


def raft_mapping(t: str = "", f: str = "") -> dict[str, str]:
    """princeton-vl RAFT (the reference's frozen flow provider,
    raft_model.py:23-50) -> models/raft.py::RAFT. Empty prefixes map a
    bare RAFT state dict onto a bare RAFT flax tree."""
    tp = f"{t}." if t else ""
    fp = f"{f}/" if f else ""
    m = {}
    m.update(_raft_encoder_mapping(f"{tp}fnet", f"{fp}fnet", "instance"))
    m.update(_raft_encoder_mapping(f"{tp}cnet", f"{fp}cnet", "batch"))
    ub = f"{tp}update_block"
    fb = f"{fp}update_block"
    m.update(basic_motion_encoder_mapping(f"{ub}.encoder", f"{fb}/encoder"))
    m.update(sep_gru2d_mapping(f"{ub}.gru", f"{fb}/gru"))
    m.update(_conv(f"{ub}.flow_head.conv1", f"{fb}/flow_conv1/Conv_0"))
    m.update(_conv(f"{ub}.flow_head.conv2", f"{fb}/flow_conv2/Conv_0"))
    m.update(_conv(f"{ub}.mask.0", f"{fb}/mask_conv1/Conv_0"))
    m.update(_conv(f"{ub}.mask.2", f"{fb}/mask_conv2/Conv_0"))
    return m


def _rs_residual_mapping(tb: str, fb: str, norm: str,
                         has_downsample: bool) -> dict[str, str]:
    m = {}
    m.update(_conv(f"{tb}.conv1", f"{fb}/conv1/Conv_0"))
    m.update(_conv(f"{tb}.conv2", f"{fb}/conv2/Conv_0"))
    if norm == "batch":
        m.update(_frozen_bn(f"{tb}.norm1", f"{fb}/norm1"))
        m.update(_frozen_bn(f"{tb}.norm2", f"{fb}/norm2"))
    if has_downsample:
        m.update(_conv(f"{tb}.downsample.0", f"{fb}/downsample/Conv_0"))
        if norm == "batch":
            m.update(_frozen_bn(f"{tb}.norm3", f"{fb}/norm3"))
            m.update(_frozen_bn(f"{tb}.downsample.1", f"{fb}/norm3"))
    return m


def rs_multi_encoder_mapping(t: str, f: str, norm: str = "batch") -> dict[str, str]:
    """RAFT-Stereo MultiBasicEncoder (downsample=2) ->
    models/raft_stereo.py::RSMultiEncoder."""
    m = {}
    m.update(_conv(f"{t}.conv1", f"{f}/conv1/Conv_0"))
    if norm == "batch":
        m.update(_frozen_bn(f"{t}.norm1", f"{f}/norm1"))
    for li in range(1, 6):
        for bj in (0, 1):
            m.update(_rs_residual_mapping(
                f"{t}.layer{li}.{bj}", f"{f}/layer{li}_{bj}", norm,
                has_downsample=(li > 1 and bj == 0),
            ))
    for label in ("outputs08", "outputs16"):
        for i in (0, 1):
            m.update(_rs_residual_mapping(
                f"{t}.{label}.{i}.0", f"{f}/{label}_{i}_res", norm,
                has_downsample=False,
            ))
            m.update(_conv(f"{t}.{label}.{i}.1", f"{f}/{label}_{i}_conv/Conv_0"))
    for i in (0, 1):
        m.update(_conv(f"{t}.outputs32.{i}", f"{f}/outputs32_{i}_conv/Conv_0"))
    return m


def raftstereo_mapping(t: str = "", f: str = "") -> dict[str, str]:
    """princeton-vl RAFT-Stereo at the reference's shipped args
    (raft_stereo_model.py:34-45) -> models/raft_stereo.py::RAFTStereo."""
    tp = f"{t}." if t else ""
    fp = f"{f}/" if f else ""
    m = {}
    m.update(_raft_encoder_mapping(f"{tp}fnet", f"{fp}fnet", "instance"))
    m.update(rs_multi_encoder_mapping(f"{tp}cnet", f"{fp}cnet", "batch"))
    ub, fb = f"{tp}update_block", f"{fp}update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        m.update(_conv(f"{ub}.encoder.{name}", f"{fb}/encoder/{name}/Conv_0"))
    for g in ("gru04", "gru08", "gru16"):
        for c in ("convz", "convr", "convq"):
            m.update(_conv(f"{ub}.{g}.{c}", f"{fb}/{g}/{c}/Conv_0"))
    m.update(_conv(f"{ub}.flow_head.conv1", f"{fb}/flow_conv1/Conv_0"))
    m.update(_conv(f"{ub}.flow_head.conv2", f"{fb}/flow_conv2/Conv_0"))
    m.update(_conv(f"{ub}.mask.0", f"{fb}/mask_conv1/Conv_0"))
    m.update(_conv(f"{ub}.mask.2", f"{fb}/mask_conv2/Conv_0"))
    for i in range(3):
        m.update(_conv(
            f"{tp}context_zqr_convs.{i}", f"{fp}context_zqr_convs_{i}/Conv_0"
        ))
    return m


def sav_update_block_mapping(t: str, f: str) -> dict[str, str]:
    """StereoAnyVideo SequenceUpdateBlock3D (reference
    stereoanyvideo_update.py:353-387) -> nn/update.py::SAVSequenceUpdateBlock3D
    (motion-encoder convs live directly on the flax block)."""
    m = {}
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        m.update(_conv(f"{t}.encoder.{name}", f"{f}/{name}/Conv_0"))
    m.update(sk_gru3d_mapping(f"{t}.gru", f"{f}/gru"))
    m.update(_conv(f"{t}.flow_head.conv1", f"{f}/flow_head/Conv_0/Conv_0"))
    m.update(_conv(f"{t}.flow_head.conv2", f"{f}/flow_head/Conv_1/Conv_0"))
    m.update(_conv(f"{t}.mask3d.0", f"{f}/mask_conv1/Conv_0"))
    m.update(_conv(f"{t}.mask3d.2", f"{f}/mask_conv2/Conv_0"))
    m.update(time_attn_mapping(f"{t}.time_attn", f"{f}/time_attn"))
    m.update(loftr_layer_mapping(
        f"{t}.space_attn.encoder_layer", f"{f}/space_attn/LoFTREncoderLayer_0"
    ))
    return m


def stereoanyvideo_mapping(include_vda: bool = True) -> dict[str, str]:
    """StereoAnyVideo (reference stereoanyvideo.py:76-91)."""
    m = basic_encoder_mapping("cnet", "cnet")
    m.update(basic_encoder_mapping("fnet", "fnet"))
    m["corr_mlp.fc1.weight"] = "corr_mlp_fc1/Dense_0/kernel"
    m["corr_mlp.fc1.bias"] = "corr_mlp_fc1/Dense_0/bias"
    m["corr_mlp.fc2.weight"] = "corr_mlp_fc2/Dense_0/kernel"
    m["corr_mlp.fc2.bias"] = "corr_mlp_fc2/Dense_0/bias"
    m.update(sav_update_block_mapping("update_block", "update_block"))
    m.update(_conv("depthnet.conv", "depthnet/conv/Conv_0"))
    if include_vda:
        from ppmstereo_tpu_torch.utils.vda_mapping import vda_mapping

        m.update(vda_mapping("depthnet.depthanything", "depthnet/depthanything"))
    return m


def multilevel_vfm_mapping(t: str, f: str) -> dict[str, str]:
    """MultiLevelEncoder_VFM (reference extractor.py:501-620) ->
    nn/encoder.py::MultiLevelEncoderVFM. Instance norms carry no params;
    the reference residual block always has a downsample projection."""
    m = {}
    m.update(_conv(f"{t}.conv1", f"{f}/Conv_0/Conv_0"))
    idx = 0
    for li in range(1, 6):
        for bj in range(2):
            tb, fb = f"{t}.layer{li}.{bj}", f"{f}/ResidualBlock_{idx}"
            idx += 1
            m.update(_conv(f"{tb}.conv1", f"{fb}/Conv_0/Conv_0"))
            m.update(_conv(f"{tb}.conv2", f"{fb}/Conv_1/Conv_0"))
            m.update(_conv(f"{tb}.downsample.0", f"{fb}/Conv_2/Conv_0"))
    for s in ("16", "8", "4"):
        m.update(_conv(f"{t}.upconv_{s}.1", f"{f}/upconv_{s}/Conv_0/Conv_0"))
        m.update(_conv(f"{t}.decode_{s}x.0", f"{f}/decode_{s}x/Conv_0/Conv_0"))
        m.update(_conv(f"{t}.decode_{s}x.3", f"{f}/decode_{s}x/Conv_1/Conv_0"))
    return m


def ppmstereo_vda_mapping(attention_type: str | None = None) -> dict[str, str]:
    """PPMStereo_VDA (reference ppmstereo_VDA.py:44-118): the base PPM
    mapping with the BasicEncoder fnet replaced by MultiLevelEncoder_VFM
    + the frozen VideoDepthAnything backbone."""
    from ppmstereo_tpu_torch.utils.ppm_mapping import ppmstereo_mapping
    from ppmstereo_tpu_torch.utils.vda_mapping import vda_mapping

    m = {
        k: v for k, v in ppmstereo_mapping(
            attention_type=attention_type, use_cnet=True
        ).items() if not k.startswith("fnet.")
    }
    m.update(multilevel_vfm_mapping("fnet", "fnet"))
    m.update(vda_mapping("backbone", "backbone"))
    return m


# torch tensors with no flax counterpart by design, per family
ZOO_DEAD_KEY_TAGS = (
    ".temporal_attn.qkv.",  # degenerate Attention never applies its qkv
    "num_batches_tracked",  # torch BatchNorm bookkeeping, no inference role
)


def is_zoo_dead_key(key: str, mapping: dict[str, str]) -> bool:
    if key in mapping:
        return False
    return any(tag in key for tag in ZOO_DEAD_KEY_TAGS)
