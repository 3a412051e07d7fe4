"""The port's building blocks (ppmstereo_tpu_torch/nn) against the JAX
package's flax modules.

Each JAX module is initialised by the JAX package (parameters it initialises
to zero are set to random values here, so that their paths count); the
parameters are carried into the port with `utils/weights.py`, and both run
on the same numpy inputs. Tolerances: f32 at small shapes, 1e-5 relative
and absolute for single layers, 1e-4 for deep stacks (encoders, the SST
block, the update cell), where f32 rounding in a different summation order
compounds over tens of layers. The bf16 case allows one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ppmstereo_tpu.nn import attention as jatt
from ppmstereo_tpu.nn import common as jcommon
from ppmstereo_tpu.nn import convnext as jconvnext
from ppmstereo_tpu.nn import encoder as jenc
from ppmstereo_tpu.nn import gru as jgru
from ppmstereo_tpu.nn import motion as jmotion
from ppmstereo_tpu.nn import norm as jnorm
from ppmstereo_tpu.nn import sst as jsst
from ppmstereo_tpu.nn import update as jupdate
from ppmstereo_tpu_torch.nn import attention as tatt
from ppmstereo_tpu_torch.nn import common as tcommon
from ppmstereo_tpu_torch.nn import convnext as tconvnext
from ppmstereo_tpu_torch.nn import encoder as tenc
from ppmstereo_tpu_torch.nn import gru as tgru
from ppmstereo_tpu_torch.nn import motion as tmotion
from ppmstereo_tpu_torch.nn import norm as tnorm
from ppmstereo_tpu_torch.nn import sst as tsst
from ppmstereo_tpu_torch.nn import update as tupdate
from ppmstereo_tpu_torch.utils.weights import flatten_params, load_flax_params

torch.set_num_threads(1)
LAYER = 1e-5
DEEP = 1e-4
AT = "self_stereo_temporal_update_time_update_space"


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _carry(jmod, tmod, args, rng, method=None):
    """Initialise `jmod` with the JAX package, fill its all-zero parameters
    with random values, load the parameters into `tmod`; return the flax
    variables."""
    variables = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args), method=method)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, variables))
    flat = {k: (0.1 * _randn(rng, *v.shape) if not v.any() else v) for k, v in flat.items()}
    load_flax_params(tmod, flat)
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _check(got, want, tol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, tol)
        return
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _run(jmod, tmod, args, rng, tol, method=None, tmethod=None):
    variables = _carry(jmod, tmod, args, rng, method=method)
    want = jmod.apply(variables, *map(jnp.asarray, args), method=method)
    with torch.no_grad():
        targs = [torch.from_numpy(a) for a in args]
        got = (tmethod(tmod, *targs) if tmethod else tmod(*targs))
    _check(got, want, tol)


# ----------------------------------------------------------------- common
@pytest.mark.parametrize("cin,feat,kernel,stride,groups", [
    (5, 7, (3, 3), 1, 1), (6, 4, (7, 7), 2, 1), (8, 8, (7, 7), 1, 8),
    (6, 5, (1, 1), 2, 1), (6, 5, (1, 1, 15), 1, 1), (6, 5, (3, 3, 3), 1, 1),
    (6, 5, (5, 1, 1), 1, 1),
])
def test_conv(rng, cin, feat, kernel, stride, groups):
    shape = (2, 4, 9, 11, cin) if len(kernel) == 3 else (2, 3, 9, 11, cin)
    _run(jcommon.Conv(feat, kernel, stride=stride, feature_group_count=groups),
         tcommon.Conv(cin, feat, kernel, stride=stride, groups=groups),
         [_randn(rng, *shape)], rng, LAYER)


def test_conv_bf16_policy(rng):
    x = _randn(rng, 2, 9, 11, 16)
    jmod = jcommon.Conv(8, (3, 3), dtype=jnp.bfloat16)
    tmod = tcommon.Conv(16, 8, (3, 3), dtype=torch.bfloat16)
    variables = _carry(jmod, tmod, [x], rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


def test_dense(rng):
    _run(jcommon.Dense(9), tcommon.Dense(6, 9), [_randn(rng, 2, 5, 6)], rng, LAYER)


def test_instance_norm(rng):
    x = 3.0 + 2.0 * _randn(rng, 2, 3, 6, 7, 5)
    _run(jnorm.InstanceNorm(), tnorm.InstanceNorm(), [x], rng, LAYER)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(rng, eps):
    _run(fnn.LayerNorm(epsilon=eps), tnorm.LayerNorm(6, eps), [_randn(rng, 2, 5, 6)], rng, LAYER)


# ---------------------------------------------------------------- encoder
@pytest.mark.parametrize("cin,planes,stride", [(8, 8, 1), (8, 12, 2)])
def test_residual_block(rng, cin, planes, stride):
    _run(jenc.ResidualBlock(planes, "instance", stride), tenc.ResidualBlock(cin, planes, stride),
         [_randn(rng, 2, 12, 10, cin)], rng, LAYER)


def test_basic_encoder(rng):
    _run(jenc.BasicEncoder(output_dim=256), tenc.BasicEncoder(256),
         [_randn(rng, 2, 32, 48, 3)], rng, DEEP)


# --------------------------------------------------------------- convnext
def test_grn(rng):
    _run(jconvnext.GRN(), tconvnext.GRN(6), [_randn(rng, 2, 4, 5, 6)], rng, LAYER)


def test_convnext_block(rng):
    _run(jconvnext.ConvNeXtBlock(16), tconvnext.ConvNeXtBlock(16),
         [_randn(rng, 2, 9, 10, 16)], rng, LAYER)


def test_context_net(rng):
    _run(jconvnext.ContextNet("tiny", output_dim=256), tconvnext.ContextNet(256),
         [_randn(rng, 1, 64, 64, 3)], rng, DEEP)


# -------------------------------------------------------------- attention
def test_position_encodings():
    np.testing.assert_array_equal(tatt.position_encoding_sine(5, 7, 32),
                                  jatt.position_encoding_sine(5, 7, 32))
    np.testing.assert_array_equal(tatt.temporal_positional_encoding(6, 16),
                                  jatt.temporal_positional_encoding(6, 16))


def test_linear_attention(rng):
    q, k, v = _randn(rng, 2, 7, 4, 8), _randn(rng, 2, 9, 4, 8), _randn(rng, 2, 9, 4, 8)
    got = tatt.linear_attention(*map(torch.from_numpy, (q, k, v)))
    _check(got, jatt.linear_attention(*map(jnp.asarray, (q, k, v))), LAYER)


def test_degenerate_attention(rng):
    x = _randn(rng, 6, 5, 32)
    _check(tatt._degenerate_attention(torch.from_numpy(x), 8),
           jatt._degenerate_attention(jnp.asarray(x), 8), LAYER)


def test_loftr_layer(rng):
    _run(jatt.LoFTREncoderLayer(32, 8), tatt.LoFTREncoderLayer(32, 8),
         [_randn(rng, 2, 12, 32), _randn(rng, 2, 15, 32)], rng, LAYER)


@pytest.mark.parametrize("names", [("self",), ("cross",), ("self", "cross")])
def test_local_feature_transformer(rng, names):
    _run(jatt.LocalFeatureTransformer(32, 8, names), tatt.LocalFeatureTransformer(32, 8, names),
         [_randn(rng, 2, 12, 32), _randn(rng, 2, 12, 32)], rng, LAYER)


def test_time_attn_block(rng):
    _run(jatt.TimeAttnBlock(dim=32, num_heads=8), tatt.TimeAttnBlock(32, 8),
         [_randn(rng, 1, 5, 3, 4, 32)], rng, LAYER)


def test_space_attn_block(rng):
    _run(jatt.SpaceAttnBlock(dim=32, num_heads=8), tatt.SpaceAttnBlock(32, 8),
         [_randn(rng, 1, 3, 4, 5, 32)], rng, LAYER)


@pytest.mark.parametrize("t", [5, 3])
def test_sst_block(rng, t):
    # t=3 exercises the nearest-frame interpolation of the time embedding
    _run(jsst.SSTBlock(dim=32, depth=2, num_frames=5, attention_type=AT),
         tsst.SSTBlock(32, 2, attention_type=AT),
         [_randn(rng, 1, t, 3, 4, 32), _randn(rng, 1, t, 3, 4, 32)], rng, DEEP)


# ----------------------------------------------------------------- motion
def test_pc_block(rng):
    _run(jmotion.PCBlock(36, 256, k_conv=(1, 7)), tmotion.PCBlock(36, 256),
         [_randn(rng, 1, 2, 6, 9, 36)], rng, LAYER)


def test_attention_qk(rng):
    _run(jmotion.AttentionQK(dim_head=16), tmotion.AttentionQK(24, 16),
         [_randn(rng, 1, 2, 5, 6, 24)], rng, LAYER)


def test_basic_motion_encoder_v2(rng):
    def both(m, flow, corr, mh, inp):
        return m(flow, corr, mh) + (m.init_hidden(inp),)

    args = [_randn(rng, 1, 2, 6, 9, 2), _randn(rng, 1, 2, 6, 9, 36),
            _randn(rng, 1, 2, 6, 9, 64), _randn(rng, 1, 2, 6, 9, 128)]
    _run(jmotion.BasicMotionEncoderV2(36), tmotion.BasicMotionEncoderV2(36, 128, True),
         args, rng, LAYER, method=both,
         tmethod=lambda m, f, c, h, i: m(f, c, h) + (m.init_hidden(i),))


# -------------------------------------------------------------------- gru
def test_sk_conv(rng):
    _run(jgru._SKConv(8, (1, 1, 15), (1, 1, 5)), tgru._SKConv(12, 8, (1, 1, 15), (1, 1, 5)),
         [_randn(rng, 1, 3, 4, 17, 12)], rng, LAYER)


def test_sk_sep_conv_gru_3d(rng):
    h, x = _randn(rng, 1, 5, 4, 6, 128), _randn(rng, 1, 5, 4, 6, 384)
    _run(jgru.SKSepConvGRU3D(hidden_dim=128), tgru.SKSepConvGRU3D(128, 384), [h, x], rng, DEEP)


# ----------------------------------------------------------------- update
def test_flow_head(rng):
    _run(jupdate.FlowHead(256, (3, 3, 3)), tupdate.FlowHead(128),
         [_randn(rng, 1, 3, 4, 5, 128)], rng, LAYER)


def test_aggregate(rng):
    _run(jupdate.Aggregate(128), tupdate.Aggregate(128), [_randn(rng, 1, 2, 3, 4, 128)],
         rng, LAYER)


@pytest.mark.parametrize("attention_type", [AT, None])
def test_sequence_update_block_3d(rng, attention_type):
    """Every entry of the cell the refinement loop calls, as it calls them."""
    def entries(m, flow, corr, mh, net, inp):
        motion, hidden, value = m.get_motion_and_value(flow, corr, mh)
        unc = m.get_uncertainty(jnp.concatenate([net, value], axis=-1))
        new_net, _, delta = m(net, inp, motion, motion + value, compute_mask=False)
        return motion, hidden, value, unc, new_net, delta, m.get_mask(new_net), \
            m.init_motion_hidden_state(inp)

    def tentries(m, flow, corr, mh, net, inp):
        motion, hidden, value = m.get_motion_and_value(flow, corr, mh)
        unc = m.get_uncertainty(torch.cat([net, value], dim=-1))
        new_net, delta = m(net, inp, motion, motion + value)
        return motion, hidden, value, unc, new_net, delta, m.get_mask(new_net), \
            m.init_motion_hidden_state(inp)

    shape = (1, 5, 3, 4)
    args = [_randn(rng, *shape, 2), _randn(rng, *shape, 36), _randn(rng, *shape, 64),
            np.tanh(_randn(rng, *shape, 128)), np.maximum(_randn(rng, *shape, 128), 0)]
    _run(jupdate.SequenceUpdateBlock3D(hidden_dim=128, cor_planes=36, mask_size=4,
                                       attention_type=attention_type),
         tupdate.SequenceUpdateBlock3D(attention_type=attention_type, with_init_hidden=True),
         args, rng, DEEP, method=entries, tmethod=tentries)
