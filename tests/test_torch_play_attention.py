"""The play attention: the port's plain versions (forward, forward with
residual, backward) against the JAX package's XLA path, its autodiff and its
Pallas kernels (interpret mode), and the CUDA kernels against the plain
versions on a card (`cuda`-marked; skip without one).

Tolerances:
  * f32 inputs, plain vs XLA / Pallas: 2e-5, as tests/test_aux.py holds the
    Pallas kernel to the XLA path (f32 sums in another order; the
    probabilities are rounded to the f32 value dtype, i.e. not at all);
    the gradients too (measured at most 1.5e-6);
  * the residual lse (base-2 log-sum-exp, values up to ~20): 1e-5;
  * bf16 inputs, plain vs XLA: the outputs are bf16, so one bf16 ulp
    (2^-7 relative) at the largest |output|; the f32 logits and softmax
    agree far below that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.kernels.play_attention import (
    _flash_bwd,
    _flash_fwd_res,
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
    # a hop of the 2-way ring at 1/4: a quarter of the FLOP; bf16 q, k, v
    # (144 MB) and the f32 state read and written (2 x 26.4 MB)
    flops, nbytes = tpa.play_attention_carry_cost(10, 5120, 25600)
    assert flops == pytest.approx(6.7e11, rel=1e-2)
    assert nbytes == pytest.approx(1.97e8, rel=1e-2)


@pytest.mark.parametrize("lk,n", [(512, 2), (700, 3), (5, 4)])
def test_carry_hops_on_cpu_make_the_attention(rng, lk, n):
    """n plain carry hops over K/V split in n chunks, normalised, equal the
    plain attention (f32: 2e-5); the wrapper takes the plain version for CPU
    tensors, returns new state tensors and counts no launch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(rng, 2, 96, lk))
    o, m, l = torch.zeros(2, 96, 128), torch.full((2, 96), -1e30), torch.zeros(2, 96)
    before = tpa.play_attention_carry.launches
    for kj, vj in zip(k.tensor_split(n, dim=1), v.tensor_split(n, dim=1)):
        o2, m2, l2 = tpa.play_attention_carry(q, kj, vj, o, m, l, SCALE)
        assert o2 is not o and (m <= m2).all()
        o, m, l = o2, m2, l2
    assert tpa.play_attention_carry.launches == before
    want = tpa.play_attention_plain(q, k, v, SCALE)
    np.testing.assert_allclose((o / l[..., None]).numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


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


def _grad_inputs(rng, b, lq, lk):
    return _inputs(rng, b, lq, lk) + (rng.standard_normal((b, lq, 128)).astype(np.float32),)


@pytest.mark.parametrize("b,lq,lk", [(2, 200, 512), (2, 96, 700), (1, 17, 5)])
def test_bwd_plain_matches_jax_grad(rng, b, lq, lk):
    """Against jax.grad of the XLA path (what the JAX package's CPU training
    differentiates), ragged sizes included."""
    q, k, v, g = _grad_inputs(rng, b, lq, lk)
    want = jax.grad(
        lambda q, k, v: jnp.sum(_play_attention_xla(q, k, v, SCALE, q_chunk=32) * g),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tpa.play_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)), SCALE, q_chunk=64)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("lq,lk,block_q,block_k", [(200, 512, 64, 128), (128, 512, 64, 256)])
def test_fwd_res_and_bwd_plain_match_flash_interpret(rng, lq, lk, block_q, block_k):
    """Against the Pallas forward-with-residuals and backward kernels in
    interpret mode (as tests/test_aux.py runs them): lse = m + log2(l)."""
    q, k, v, g = _grad_inputs(rng, 2, lq, lk)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, m2, l = _flash_fwd_res(jq, jk, jv, SCALE, block_q, block_k, interpret=True)
    t_out, t_lse = tpa.play_attention_fwd_res_plain(*map(torch.from_numpy, (q, k, v)), SCALE)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    want_lse = np.asarray(m2)[:, :lq, 0] + np.log2(np.asarray(l)[:, :lq, 0])
    assert t_lse.shape == (2, lq)
    np.testing.assert_allclose(t_lse.numpy(), want_lse, rtol=0, atol=1e-5)
    want = _flash_bwd(jq, jk, jv, out, m2, l, jg, SCALE, block_q, block_k, interpret=True)
    got = tpa.play_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)), SCALE)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5, err_msg=name)


def test_autograd_on_cpu_uses_the_plain_versions(rng):
    """With inputs that require a gradient, play_attention goes through the
    autograd Function: on the CPU the plain forward and the plain backward,
    and no kernel launch is counted. The card's path computes Di with
    `play_attention_di`, which must equal rowsum(dO o O) taken on two f32
    copies (f32 tolerance: the products of bf16 values are exact in f32,
    only the sum's order could differ)."""
    q, k, v, g = (torch.from_numpy(x) for x in _grad_inputs(rng, 2, 40, 150))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counters = (tpa.play_attention, tpa.play_attention_fwd_res,
                tpa.play_attention_bwd_dq, tpa.play_attention_bwd_dkv)
    before = [fn.launches for fn in counters]
    out = tpa.play_attention(*leaves, SCALE)
    out.backward(g)
    assert [fn.launches for fn in counters] == before
    torch.testing.assert_close(out.detach(), tpa.play_attention_plain(q, k, v, SCALE),
                               rtol=0, atol=0)
    for leaf, want in zip(leaves, tpa.play_attention_bwd_plain(q, k, v, g, SCALE)):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0)
    with torch.no_grad():  # inference takes the forward without residual
        assert not tpa.play_attention(*leaves, SCALE).requires_grad
    o16, g16 = out.detach().bfloat16(), g.bfloat16()
    di = tpa.play_attention_di(o16, g16)
    assert di.dtype == torch.float32 and di.shape == (2, 40)
    torch.testing.assert_close(di, (g16.float() * o16.float()).sum(dim=-1), rtol=1.3e-6, atol=1e-5)


def test_bwd_cost_model():
    flops, _ = tpa.play_attention_bwd_cost(10, 10240, 51200)
    assert flops / 989e12 * 1e3 == pytest.approx(6.8, rel=1e-2)


def test_bwd_kernel_cost_models():
    """Kernel 3 (dq: S, dP, dS K) and kernel 4 (dk/dv: S, dP, P^T dO,
    dS^T Q) at the 1/4 training shape: 4.07 and 5.43 ms at 989 TFLOP/s,
    7 products between them against the backward's 5; bytes: every bf16
    input read once, each output written once, lse and Di read once."""
    b, lq, lk, d = 10, 10240, 51200, 128
    dq_flops, dq_bytes = tpa.play_attention_bwd_dq_cost(b, lq, lk)
    dkv_flops, dkv_bytes = tpa.play_attention_bwd_dkv_cost(b, lq, lk)
    assert dq_flops / 989e12 * 1e3 == pytest.approx(4.071, rel=1e-3)
    assert dkv_flops / 989e12 * 1e3 == pytest.approx(5.428, rel=1e-3)
    assert dq_flops + dkv_flops == pytest.approx(7 / 5 * tpa.play_attention_bwd_cost(b, lq, lk)[0])
    assert dq_bytes == 2 * b * d * (3 * lq + 2 * lk) + 8 * b * lq  # q, dO, dq; k, v; lse, Di
    assert dkv_bytes == 2 * b * d * (2 * lq + 4 * lk) + 8 * b * lq  # q, dO; k, v, dk, dv
    assert max(dq_flops / 989e12, dq_bytes / 3.35e12) == dq_flops / 989e12  # bound by operations


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk", [(2, 640, 3200), (3, 1000, 4999), (2, 65, 129), (1, 17, 5)])
def test_training_kernels_match_plain_on_card(b, lq, lk):
    """Kernels 2-4 against the plain versions at the limits chip_smoke.py
    states: kernel 2's o equals kernel 1's bit for bit, its lse within
    2^-12; dq, dk, dv within 1.5 bf16 ulps at the largest |value| and
    2^-7.5 of the mean |value| on average, and a second call gives the
    same bits (no atomics). 2 x 65 x 129 leaves one query past a 64-row
    tile and one key past a 128-key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
               for n in (lq, lk, lk))
    do = torch.randn(b, lq, 128, generator=gen, device="cuda").bfloat16()
    launches = [fn.launches for fn in (tpa.play_attention_fwd_res, tpa.play_attention_bwd_dq,
                                       tpa.play_attention_bwd_dkv)]
    out, lse = tpa.play_attention_fwd_res(q, k, v, SCALE)
    grads = tpa.play_attention_bwd(q, k, v, out, lse, do, SCALE)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (tpa.play_attention_fwd_res, tpa.play_attention_bwd_dq,
                                   tpa.play_attention_bwd_dkv)] == [n + 1 for n in launches]
    assert torch.equal(out, tpa.play_attention(q, k, v, SCALE))
    _, want_lse = tpa.play_attention_fwd_res_plain(q, k, v, SCALE)
    assert (lse - want_lse).abs().max().item() <= 2**-12
    for got, want in zip(grads, tpa.play_attention_bwd_plain(q, k, v, do, SCALE)):
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= 3 * 2**-8 * want.float().abs().max().item()
        assert diff.mean().item() <= 2**-7.5 * want.float().abs().mean().item()
    again = tpa.play_attention_bwd(q, k, v, out, lse, do, SCALE)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    with pytest.raises(ValueError, match="float32"):
        tpa.play_attention_bwd_dq(q, k, v, do, lse.double(), lse, SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk", [(2, 640, 3200), (3, 1000, 4999), (1, 17, 5)])
def test_carry_kernel_matches_plain_on_card(b, lq, lk):
    """Kernel 5 over K/V split in 2 hops, each hop against the plain hop on
    the same incoming state at the limits chip_smoke.py states (o: 2^-7
    max|o| + 2^-8 max(l) max|v|; m: 2^-12; l: 2^-16 max l), the state
    updated in place; one hop normalised agrees with kernel 1 (a separate
    kernel, which sums in another order) at kernel 1's o limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
               for n in (lq, lk, lk))
    o = torch.zeros(b, lq, 128, device="cuda")
    m = torch.full((b, lq), -1e30, device="cuda")
    l = torch.zeros(b, lq, device="cuda")
    before = tpa.play_attention_carry.launches
    for kj, vj in zip(k.tensor_split(2, dim=1), v.tensor_split(2, dim=1)):
        kj, vj = kj.contiguous(), vj.contiguous()
        ro, rm, rl = tpa.play_attention_carry_plain(q, kj, vj, o, m, l, SCALE)
        got = tpa.play_attention_carry(q, kj, vj, o, m, l, SCALE)
        torch.cuda.synchronize()
        assert all(g is x for g, x in zip(got, (o, m, l)))
        o_tol = (2**-7 * ro.abs().max().item()
                 + 2**-8 * rl.max().item() * vj.float().abs().max().item())
        assert (o - ro).abs().max().item() <= o_tol
        assert (m - rm).abs().max().item() <= 2**-12
        assert (l - rl).abs().max().item() <= 2**-16 * rl.max().item()
    assert tpa.play_attention_carry.launches == before + 2
    o = torch.zeros(b, lq, 128, device="cuda")
    m = torch.full((b, lq), -1e30, device="cuda")
    l = torch.zeros(b, lq, device="cuda")
    tpa.play_attention_carry(q, k, v, o, m, l, SCALE)
    whole = tpa.play_attention(q, k, v, SCALE).float()
    diff = ((o * (1.0 / l)[..., None]).bfloat16().float() - whole).abs()
    assert diff.max().item() <= (2**-7 * whole.abs().max().item()
                                 + 2**-8 * v.float().abs().max().item())
    assert diff.mean().item() <= 2**-8 * whole.abs().mean().item()
    with pytest.raises(ValueError, match="float32"):
        tpa.play_attention_carry(q, k, v, o.bfloat16(), m, l, SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk", [(2, 65, 129), (3, 1000, 4999)])
def test_carry_kernel_from_a_state_on_card(b, lq, lk):
    """Kernel 5 (the carry mode of csrc/play_attention_fwd.cu) from a state
    that is not empty (a plain hop over another block of keys), against the
    plain hop on that state at the limits chip_smoke.py states; and two
    launches from the same state give the same bits (no atomics). 2 x 65 x
    129 leaves one query row past a 64-row consumer tile and one key past a
    128-key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, k0, v0 = (torch.randn(b, n, 128, generator=gen, device="cuda").bfloat16()
                       for n in (lq, lk, lk, lk, lk))
    empty = (torch.zeros(b, lq, 128, device="cuda"), torch.full((b, lq), -1e30, device="cuda"),
             torch.zeros(b, lq, device="cuda"))
    state = tpa.play_attention_carry_plain(q, k0, v0, *empty, SCALE)
    ro, rm, rl = tpa.play_attention_carry_plain(q, k, v, *state, SCALE)
    before = tpa.play_attention_carry.launches
    runs = [tpa.play_attention_carry(q, k, v, *(x.clone() for x in state), SCALE)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tpa.play_attention_carry.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    o, m, l = runs[0]
    o_tol = 2**-7 * ro.abs().max().item() + 2**-8 * rl.max().item() * v.float().abs().max().item()
    assert (o - ro).abs().max().item() <= o_tol
    assert (o - ro).abs().mean().item() <= 2**-8 * ro.abs().mean().item()
    assert (m - rm).abs().max().item() <= 2**-12
    assert (l - rl).abs().max().item() <= 2**-16 * rl.max().item()
    # the state mattered: the hop from the empty state is far from it
    fresh = tpa.play_attention_carry_plain(q, k, v, *empty, SCALE)
    assert (fresh[2] - rl).abs().max().item() > 2**-16 * rl.max().item()
