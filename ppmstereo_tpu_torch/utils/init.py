"""A fresh initialisation of the port's models that follows the JAX
modules' initializers (not torch's defaults), so a run from scratch starts
from the same distributions as the JAX package's `init` of the same model
(PPMStereo with and without the VDA backbone, DynamicStereo, RAFT-Stereo,
BiDAStereo with its RAFT, StereoAnyVideo):

  * Dense and Conv layers of the JAX `Dense` / `Conv` wrappers: kernel
    variance_scaling(1/3, fan_in, uniform) = U(+-1/sqrt(fan_in)), bias
    U(+-1/sqrt(fan_in)) (`torch_conv_kernel_init`, `torch_bias_init`,
    ppmstereo_tpu/nn/common.py);
  * the feature encoders' convs (`BasicEncoder`; RAFT's and RAFT-Stereo's
    encoders, their output heads included): kernel variance_scaling(2,
    fan_out, truncated normal) (`kaiming_out`, nn/encoder.py,
    models/raft.py, models/raft_stereo.py), the same bias;
  * the LoFTR layers' projections and MLP: xavier_uniform, no bias
    (nn/attention.py);
  * the temporal attention's output projection `temporal_fc`: zeros;
  * the ConvNeXt backbone's pointwise layers and down-sampling convs:
    truncated normal of std 0.02 cut at +-2 std, zero bias; GRN gamma and
    beta zeros (nn/convnext.py);
  * LayerNorm scale 1, bias 0; the SST `time_embed` and the play blend
    `beta`: zeros;
  * FrozenBatchNorm scale 1, bias 0, mean 0, var 1; BiDAStereo's initial
    motion state `init_hidden_state`: a unit normal;
  * the Video-Depth-Anything backbone (nn/vda): DINOv2's dense layers and
    `pos_embed` truncated normal of std 0.02, zero biases and `cls_token`,
    LayerScale 1; its patch embedding, the motion modules' dense layers and
    the DPT head's transposed convolutions lecun_normal (flax's default),
    zero bias; the motion modules' `proj_out` zeros; GroupNorm scale 1,
    bias 0; MultiLevelEncoderVFM's convs `kaiming_out`.

The baselines have no trained weights in the repository, so on the card
they run from this initialisation: it only has to give finite,
non-degenerate outputs, and it does (chip_smoke.py's zoo phase).

JAX draws from its own generator, so the values differ; the distributions
are the same (tests/test_torch_train.py compares every tensor's std).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ppmstereo_tpu_torch.models.bidastereo import MultiMotionEncoder
from ppmstereo_tpu_torch.models.raft import FrozenBatchNorm, RAFTTrunk
from ppmstereo_tpu_torch.nn.attention import LoFTREncoderLayer, TimeAttnBlock
from ppmstereo_tpu_torch.nn.common import ConvND, Linear
from ppmstereo_tpu_torch.nn.convnext import GRN, ConvNeXtBlock, ConvNeXtV2
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder, MultiLevelEncoderVFM
from ppmstereo_tpu_torch.nn.norm import GroupNorm, LayerNorm
from ppmstereo_tpu_torch.nn.vda.dinov2 import DINOv2, LayerScale
from ppmstereo_tpu_torch.nn.vda.motion import TemporalModule

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _fans(weight: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of a Linear (out, in) or conv (out, in/g, *k) weight."""
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _trunc_normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal of std `std` (before truncation) cut at +-2 std."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def _lecun_normal(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: variance_scaling(1, fan_in, truncated normal)."""
    _trunc_normal(weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


def init_model(model: nn.Module, seed: int = 0) -> None:
    """Initialise every parameter (and FrozenBatchNorm's statistics) of a
    port model in place, on the CPU generator seeded with `seed` (move the
    model to its device after)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (ConvND, Linear)):
                fan_in, _ = _fans(mod.weight)
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, (LayerNorm, GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, GRN):
                mod.gamma.zero_()
                mod.beta.zero_()
            elif isinstance(mod, FrozenBatchNorm):
                for t, v in ((mod.weight, 1.0), (mod.bias, 0.0), (mod.mean, 0.0), (mod.var, 1.0)):
                    t.fill_(v)
        encoders = [m for m in model.modules()
                    if isinstance(m, (BasicEncoder, RAFTTrunk, MultiLevelEncoderVFM))]
        for mod in (m for enc in encoders for m in enc.modules()):
            if isinstance(mod, ConvND):
                _, fan_out = _fans(mod.weight)
                _trunc_normal(mod.weight, math.sqrt(2.0 / fan_out) / _TRUNC_STD, gen)
        for mod in model.modules():
            if isinstance(mod, LoFTREncoderLayer):
                for lin in mod.modules():
                    if isinstance(lin, Linear):
                        nn.init.xavier_uniform_(lin.weight, generator=gen)
            elif isinstance(mod, TimeAttnBlock):
                mod.temporal_fc.weight.zero_()
                mod.temporal_fc.bias.zero_()
            elif isinstance(mod, ConvNeXtV2):
                layers = [m for name, m in mod.named_children() if name.startswith("Conv_")]
                for block in mod.children():
                    if isinstance(block, ConvNeXtBlock):
                        layers += [block.Dense_0, block.Dense_1]
                for layer in layers:
                    _trunc_normal(layer.weight, 0.02, gen)
                    layer.bias.zero_()
            elif isinstance(mod, MultiMotionEncoder):
                mod.init_hidden_state.normal_(generator=gen)
            elif isinstance(mod, DINOv2):
                _lecun_normal(mod.patch_embed.weight, _fans(mod.patch_embed.weight)[0], gen)
                mod.patch_embed.bias.zero_()
                mod.cls_token.zero_()
                _trunc_normal(mod.pos_embed, 0.02, gen)
                for lin in mod.modules():
                    if isinstance(lin, Linear):
                        _trunc_normal(lin.weight, 0.02, gen)
                        lin.bias.zero_()
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(1.0)
            elif isinstance(mod, TemporalModule):
                for lin in mod.modules():
                    if isinstance(lin, Linear):
                        _lecun_normal(lin.weight, lin.weight.shape[1], gen)
                        if lin.bias is not None:
                            lin.bias.zero_()
                mod.proj_out.weight.zero_()
                mod.proj_out.bias.zero_()
            elif isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw)
                _lecun_normal(mod.weight, mod.weight.shape[0] * math.prod(mod.weight.shape[2:]),
                              gen)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(("time_embed", "aggregator.beta")):
                p.zero_()


init_ppmstereo = init_model  # the trainer's and the tests' name
