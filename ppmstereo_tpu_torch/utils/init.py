"""A fresh initialisation of PPMStereo that follows the JAX modules'
initializers (not torch's defaults), so a run from scratch starts from the
same distributions as the JAX package's `PPMStereo.init`:

  * Dense and Conv layers of the JAX `Dense` / `Conv` wrappers: kernel
    variance_scaling(1/3, fan_in, uniform) = U(+-1/sqrt(fan_in)), bias
    U(+-1/sqrt(fan_in)) (`torch_conv_kernel_init`, `torch_bias_init`,
    ppmstereo_tpu/nn/common.py);
  * the feature encoder's convs (`fnet`): kernel variance_scaling(2,
    fan_out, truncated normal) (`kaiming_out`, nn/encoder.py), the same bias;
  * the LoFTR layers' projections and MLP: xavier_uniform, no bias
    (nn/attention.py);
  * the temporal attention's output projection `temporal_fc`: zeros;
  * the ConvNeXt backbone's pointwise layers and down-sampling convs:
    truncated normal of std 0.02 cut at +-2 std, zero bias; GRN gamma and
    beta zeros (nn/convnext.py);
  * LayerNorm scale 1, bias 0; the SST `time_embed` and the play blend
    `beta`: zeros.

JAX draws from its own generator, so the values differ; the distributions
are the same (tests/test_torch_train.py compares every tensor's std).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ppmstereo_tpu_torch.nn.attention import LoFTREncoderLayer, TimeAttnBlock
from ppmstereo_tpu_torch.nn.common import ConvND, Linear
from ppmstereo_tpu_torch.nn.convnext import GRN, ConvNeXtBlock, ConvNeXtV2
from ppmstereo_tpu_torch.nn.norm import LayerNorm

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _fans(weight: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of a Linear (out, in) or conv (out, in/g, *k) weight."""
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _trunc_normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal of std `std` (before truncation) cut at +-2 std."""
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def init_ppmstereo(model: nn.Module, seed: int = 0) -> None:
    """Initialise every parameter of a port PPMStereo in place, on the CPU
    generator seeded with `seed` (move the model to its device after)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (ConvND, Linear)):
                fan_in, _ = _fans(mod.weight)
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, GRN):
                mod.gamma.zero_()
                mod.beta.zero_()
        for mod in model.fnet.modules():
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
        for name, p in model.named_parameters():
            if name.endswith(("time_embed", "aggregator.beta")):
                p.zero_()
