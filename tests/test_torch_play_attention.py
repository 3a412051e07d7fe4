"""The play attention: the port's plain version against the JAX package's
XLA path and its Pallas kernel (interpret mode), and the CUDA kernel against
the plain version on a card (`cuda`-marked; skips without one).

Tolerances:
  * f32 inputs, plain vs XLA / Pallas: 2e-5, as tests/test_aux.py holds the
    Pallas kernel to the XLA path (f32 sums in another order; the
    probabilities are rounded to the f32 value dtype, i.e. not at all);
  * bf16 inputs, plain vs XLA: the outputs are bf16, so one bf16 ulp
    (2^-7 relative) at the largest |output|; the f32 logits and softmax
    agree far below that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.kernels.play_attention import (
    _play_attention_pallas,
    _play_attention_xla,
)
from ppmstereo_tpu_torch.kernels import play_attention as tpa

torch.set_num_threads(1)
SCALE = 0.13


def _inputs(rng, b, lq, lk, d=128):
    return tuple(rng.standard_normal((b, n, d)).astype(np.float32) for n in (lq, lk, lk))


@pytest.mark.parametrize("lq,lk", [(96, 256), (96, 200), (70, 700), (128, 1280)])
def test_plain_matches_xla_f32(rng, lq, lk):
    q, k, v = _inputs(rng, 2, lq, lk)
    got = tpa.play_attention_plain(*map(torch.from_numpy, (q, k, v)), SCALE, q_chunk=32)
    want = _play_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, q_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lk,block_k", [(256, 128), (200, 128), (400, 256), (700, None)])
def test_plain_matches_pallas_interpret(rng, lk, block_k):
    # unaligned Lk (200, 400, 700) exercises the kernel's key-tail mask
    q, k, v = _inputs(rng, 2, 96, lk)
    got = tpa.play_attention_plain(*map(torch.from_numpy, (q, k, v)), SCALE)
    want = _play_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE,
                                  block_q=64, block_k=block_k, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_matches_xla_bf16(rng):
    q, k, v = _inputs(rng, 3, 80, 400)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    scale = tpa.play_scale(128)
    got = tpa.play_attention_plain(tq, tk, tv, scale, q_chunk=32)
    want = np.asarray(_play_attention_xla(jq, jk, jv, scale, q_chunk=32).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    tol = 2**-7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_wrapper_on_cpu_uses_plain_and_counts_no_launch(rng):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(rng, 2, 40, 150))
    before = tpa.play_attention.launches
    got = tpa.play_attention(q, k, v, SCALE)
    assert tpa.play_attention.launches == before
    torch.testing.assert_close(got, tpa.play_attention_plain(q, k, v, SCALE), rtol=0, atol=0)


def test_cost_model():
    flops, nbytes = tpa.play_attention_cost(10, 10240, 51200)
    assert flops == pytest.approx(2.68e12, rel=1e-2)
    assert nbytes == pytest.approx(3.15e8, rel=1e-2)
    assert tpa.play_scale(128) == pytest.approx(128**-0.5 * np.log(256) / np.log(12000))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk", [(2, 640, 3200), (3, 1000, 4999), (1, 17, 5)])
def test_kernel_matches_plain_on_card(b, lq, lk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
               for n in (lq, lk, lk))
    before = tpa.play_attention.launches
    got = tpa.play_attention(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert tpa.play_attention.launches == before + 1
    want = tpa.play_attention_plain(q, k, v, SCALE)
    # one bf16 ulp at the largest |output| plus the bf16 rounding of the
    # probabilities (2^-8 max|v|), as chip_smoke.py states
    tol = 2**-7 * want.float().abs().max().item() + 2**-8 * v.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= tol
    # and on average within 2^-8 of the mean |output|: the probabilities'
    # roundings put it near 2^-9, an output one ulp off everywhere at 2^-7.5
    assert diff.mean().item() <= 2**-8 * want.float().abs().mean().item()
    with pytest.raises(ValueError, match="bfloat16"):
        tpa.play_attention(q.float(), k.float(), v.float(), SCALE)
