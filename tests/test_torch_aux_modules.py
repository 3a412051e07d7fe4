"""The modules that no model calls, against the JAX package's: full
attention and the `attention` switch of the LoFTR layers, `Mlp`,
`RelPosEmb`, `SKMotionEncoder`, the ResNet-FPN encoders and the temporal-FFT
flow head (ppmstereo_tpu_torch/nn).

Each JAX module's parameter tree comes from `jax.eval_shape` of its init
(an eager flax init of these modules compiles every initialiser, 5-17 s
each); its parameters are drawn from a seeded numpy generator at a
1 / sqrt(fan-in) scale (so `alpha1`, which the JAX package initialises to
zero, counts), carried into the port with `utils/weights.py`, and both run
on the same seeded numpy inputs in f32. Tolerances are those of
tests/test_torch_ops.py, none looser: 1e-5 relative and absolute (the
ResNet-FPN encoders and the FFT head included), 1e-6 where the result is a
gather of the parameters; one bf16 ulp for the bf16 case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.nn import attention as jatt
from ppmstereo_tpu.nn import encoder as jenc
from ppmstereo_tpu.nn import fft_head as jfft
from ppmstereo_tpu.nn import motion as jmotion
from ppmstereo_tpu_torch.nn import attention as tatt
from ppmstereo_tpu_torch.nn import encoder as tenc
from ppmstereo_tpu_torch.nn import fft_head as tfft
from ppmstereo_tpu_torch.nn import motion as tmotion
from ppmstereo_tpu_torch.utils.weights import flatten_params, load_flax_params
from tests.test_torch_blocks import _check, _randn

torch.set_num_threads(1)
F32 = 1e-5
EXACT = 1e-6


def _draw(jmod, args, rng) -> dict:
    """Seeded flat parameters of `jmod` ({"params/a/b/leaf": array}), drawn
    N(0, 1 / fan-in) over the leaf's leading axes."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))
    flat = flatten_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    return {k: (_randn(rng, *v.shape) / np.sqrt(np.prod(v.shape[:-1]) if v.ndim > 1 else 10.0))
            for k, v in flat.items()}


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _jax_out(jmod, tmod, args, rng):
    """Carry seeded parameters of `jmod` into `tmod` and return the JAX
    output."""
    flat = _draw(jmod, args, rng)
    load_flax_params(tmod, flat)
    return jmod.apply(_tree(flat), *map(jnp.asarray, args))


def _port_out(tmod, args):
    with torch.no_grad():
        return tmod(*map(torch.from_numpy, args))


def _check_complex(got, want, tol):
    want = np.asarray(want)
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    _check(got.real, want.real, tol)
    _check(got.imag, want.imag, tol)


def test_full_attention(rng):
    q, k, v = _randn(rng, 2, 7, 2, 8), _randn(rng, 2, 9, 2, 8), _randn(rng, 2, 9, 2, 8)
    got = tatt.full_attention(*map(torch.from_numpy, (q, k, v)))
    _check(got, jatt.full_attention(*map(jnp.asarray, (q, k, v))), F32)


def test_full_attention_bf16_casts_probabilities_to_v(rng):
    q, k, v = _randn(rng, 1, 5, 2, 8), _randn(rng, 1, 6, 2, 8), _randn(rng, 1, 6, 2, 8)
    got = tatt.full_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    want = jatt.full_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _check(got, np.asarray(want.astype(jnp.float32)), 2 ** -7)  # one bf16 ulp


@pytest.mark.parametrize("attention", ["linear", "full"])
def test_loftr_layer_attention_switch(rng, attention):
    x, src = _randn(rng, 2, 12, 16), _randn(rng, 2, 10, 16)
    tmod = tatt.LoFTREncoderLayer(16, 2, attention=attention)
    want = _jax_out(jatt.LoFTREncoderLayer(16, 2, attention), tmod, (x, src), rng)
    _check(_port_out(tmod, (x, src)), want, F32)


def test_attention_switch_changes_the_layer(rng):
    """The two switches give other answers on the same weights, and an
    unknown one raises."""
    x = torch.from_numpy(_randn(rng, 1, 6, 16))
    lin = tatt.LoFTREncoderLayer(16, 2)
    full = tatt.LoFTREncoderLayer(16, 2, attention="full")
    full.load_state_dict(lin.state_dict())
    with torch.no_grad():
        assert (lin(x, x) - full(x, x)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="attention"):
        tatt.LoFTREncoderLayer(16, 2, attention="softmax")


@pytest.mark.parametrize("attention", ["linear", "full"])
def test_local_feature_transformer_attention_switch(rng, attention):
    f0, f1 = _randn(rng, 2, 12, 16), _randn(rng, 2, 12, 16)
    names = ("self", "cross")
    tmod = tatt.LocalFeatureTransformer(16, 2, names, attention=attention)
    want = _jax_out(jatt.LocalFeatureTransformer(16, 2, names, attention), tmod, (f0, f1), rng)
    _check(_port_out(tmod, (f0, f1)), want, F32)


@pytest.mark.parametrize("hidden,out", [(None, None), (24, 12)])
def test_mlp(rng, hidden, out):
    x = _randn(rng, 2, 5, 16)
    tmod = tatt.Mlp(16, hidden, out)
    want = _jax_out(jatt.Mlp(hidden, out), tmod, (x,), rng)
    _check(_port_out(tmod, (x,)), want, F32)


def test_rel_pos_emb(rng):
    """Scores of a 4 x 5 query grid against max_pos_size 6: the gathers are
    exact, the two products f32."""
    q = _randn(rng, 2, 2, 4, 5, 8)
    tmod = tatt.RelPosEmb(6, 8)
    want = _jax_out(jatt.RelPosEmb(6, 8), tmod, (q,), rng)
    assert tuple(tmod.rel_height.shape) == (11, 8)
    got = _port_out(tmod, (q,))
    assert got.shape == (2, 2, 4, 5, 4, 5)
    _check(got, want, F32)


def test_rel_pos_emb_indexes_the_embeddings(rng):
    """A one-hot query on the height axis reads rel_height's rows exactly."""
    tmod = tatt.RelPosEmb(4, 3)
    with torch.no_grad():
        tmod.rel_width.zero_()
        q = torch.zeros(1, 1, 3, 2, 3)
        q[..., 0] = 1.0
        got = tmod(q)
    idx = np.arange(3)[None, :] - np.arange(3)[:, None] + 3  # [x, u] = u - x + 3
    want = tmod.rel_height.detach().numpy()[idx, 0]  # (x, u)
    _check(got[0, 0, :, 0, :, 0], want, EXACT)


@pytest.mark.parametrize("k_conv", [(1, 15), (1, 3)])
def test_sk_motion_encoder(rng, k_conv):
    flow, corr = _randn(rng, 1, 2, 8, 10, 2), _randn(rng, 1, 2, 8, 10, 9)
    tmod = tmotion.SKMotionEncoder(9, k_conv)
    want = _jax_out(jmotion.SKMotionEncoder(9, k_conv), tmod, (flow, corr), rng)
    got = _port_out(tmod, (flow, corr))
    assert got.shape == (1, 2, 8, 10, 128)
    _check(got, want, F32)


@pytest.fixture(scope="module")
def fpn_input():
    return _randn(np.random.default_rng(2), 2, 32, 48, 3)


@pytest.mark.parametrize("norm_fn", ["instance", "group", "none"])
def test_resnet_fpn(rng, fpn_input, norm_fn):
    tmod = tenc.ResNetFPN(32, norm_fn)
    want = _jax_out(jenc.ResNetFPN(32, norm_fn), tmod, (fpn_input,), rng)
    got = _port_out(tmod, (fpn_input,))
    assert got.shape == (2, 8, 12, 32)
    _check(got, want, F32)


@pytest.mark.parametrize("norm_fn", ["instance", "group"])
def test_multi_level_resnet_fpn(rng, fpn_input, norm_fn):
    tmod = tenc.MultiLevelResNetFPN(32, norm_fn)
    want = _jax_out(jenc.MultiLevelResNetFPN(32, norm_fn), tmod, (fpn_input,), rng)
    got = _port_out(tmod, (fpn_input,))
    assert [tuple(g.shape) for g in got] == [(2, 8, 12, 32), (2, 4, 6, 32), (2, 2, 3, 32)]
    _check(got, want, F32)


def test_resnet_fpn_refuses_an_unknown_norm():
    with pytest.raises(ValueError, match="norm_fn"):
        tenc.ResNetFPN(32, "batch")


def _spectrum(rng, *shape):
    return (_randn(rng, *shape) + 1j * _randn(rng, *shape)).astype(np.complex64)


def test_fft_linear(rng):
    x = _spectrum(rng, 1, 4, 3, 5, 6)
    tmod = tfft.FFTLinear(6, 7)
    want = _jax_out(jfft.FFTLinear(7), tmod, (x,), rng)
    assert tuple(tmod.complex_weight.shape) == (7, 6, 2)
    _check_complex(_port_out(tmod, (x,)), want, F32)


def test_fft_batch_norm(rng):
    x = _spectrum(rng, 2, 4, 3, 5, 6) * 3.0 + 0.5
    want = jfft.FFTBatchNorm().apply({}, jnp.asarray(x))
    _check_complex(_port_out(tfft.FFTBatchNorm(), (x,)), want, F32)


def test_temporal_fft(rng):
    x = _randn(rng, 1, 4, 6, 5, 8)
    tmod = tfft.TemporalFFT(8)
    want = _jax_out(jfft.TemporalFFT(8), tmod, (x,), rng)
    _check_complex(_port_out(tmod, (x,)), want, F32)


@pytest.mark.parametrize("frames", [4, 5])
def test_flow_head_3d_fft(rng, frames):
    x = _randn(rng, 1, frames, 8, 10, 16)
    tmod = tfft.FlowHead3DFFT(16, 32)
    want = _jax_out(jfft.FlowHead3DFFT(32), tmod, (x,), rng)
    got = _port_out(tmod, (x,))
    assert got.shape == (1, frames, 8, 10, 2)
    _check(got, want, F32)
