"""The pyramid lookup, kernel 6's plain version (`ops/corr.py::corr_lookup`,
which `kernels/corr_lookup.py::corr_lookup_kernel` takes for CPU tensors),
against the JAX package's Pallas lookup kernel in interpret mode and its
XLA lookup, on the same pyramid and coordinates, in f32 and on a bf16
pyramid; and the CUDA kernel against the plain version on a card
(`cuda`-marked; skips without one).

Tolerance 1e-6 in f32: every output is a(1 - f) + b f of two pyramid values
in f32 in all three (the Pallas kernel's one-hot sum adds only zeros besides
the two taps), so they agree to a rounding or two of values below ~10. On a
bf16 pyramid all three widen the two bf16 values exactly to f32 and blend in
f32: the plain lookup equals the XLA lookup bit for bit, and is within the
same 1e-6 of the Pallas kernel (measured: one f32 ulp, 1.2e-7, where its
one-hot reduction rounds once more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.kernels.corr_lookup import corr_lookup_pallas
from ppmstereo_tpu.ops import corr as jcorr
from ppmstereo_tpu_torch.kernels import corr_lookup as kl
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid

torch.set_num_threads(1)


def _inputs(rng, b, h, w1, w2, c=16):
    """A pyramid built by both packages from one pair of feature maps (the
    port's and the JAX package's must agree), and coordinates as the model
    makes them: the pixel column plus a flow, some past either end."""
    f1 = rng.standard_normal((b, h, w1, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w2, c)).astype(np.float32)
    coords = (np.arange(w1, dtype=np.float32)
              + rng.standard_normal((b, h, w1)).astype(np.float32) * 0.3 * w2)
    tpyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    for t, j in zip(tpyr, jpyr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    return tpyr, jpyr, coords


@pytest.mark.parametrize("b,h,w1,w2", [(2, 12, 64, 64), (3, 7, 45, 45)])
def test_lookup_matches_jax(rng, b, h, w1, w2):
    """A small pyramid, and a ragged one: H not a multiple of the Pallas
    kernel's 8-row block, W2 not a power of two (levels 45, 22, 11, 5)."""
    tpyr, jpyr, coords = _inputs(rng, b, h, w1, w2)
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(tpyr, torch.from_numpy(coords)).numpy()
    assert kl.corr_lookup_kernel.launches == before  # the CPU takes the plain version
    assert got.shape == (b, h, w1, 36) and got.dtype == np.float32
    pallas = np.asarray(corr_lookup_pallas(jpyr, jnp.asarray(coords), interpret=True))
    xla = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), impl="gather"))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    assert (got == 0).any() and (got != 0).mean() > 0.5  # both sides of the rows reached


def _bf16_inputs(rng, b, h, w1, w2):
    """The pyramid of `_inputs` rounded to bf16 in the port, and the same
    bf16 values in the JAX package (exact: f32 holds every bf16 value)."""
    tpyr, _, coords = _inputs(rng, b, h, w1, w2)
    tpyr = [c.to(torch.bfloat16) for c in tpyr]
    jpyr = [jnp.asarray(c.float().numpy()).astype(jnp.bfloat16) for c in tpyr]
    return tpyr, jpyr, coords


@pytest.mark.parametrize("b,h,w1,w2", [(2, 12, 64, 64), (3, 7, 45, 45)])
def test_bf16_pyramid_lookup_matches_jax(rng, b, h, w1, w2):
    """The main path's pyramid is bf16: the plain lookup (and so the kernel's
    CPU form) on it against the JAX package's XLA lookup and Pallas kernel
    (interpret mode) on the same bf16 pyramid. The output is f32."""
    tpyr, jpyr, coords = _bf16_inputs(rng, b, h, w1, w2)
    got = kl.corr_lookup_kernel(tpyr, torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == (b, h, w1, 36)
    got = got.numpy()
    pallas = np.asarray(corr_lookup_pallas(jpyr, jnp.asarray(coords), interpret=True))
    xla = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), impl="gather"))
    assert pallas.dtype == xla.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, xla)
    # the lookup of the bf16 values widened to f32 first, bit for bit
    f32 = kl.corr_lookup_kernel([c.float() for c in tpyr], torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, f32)  # the same values, widened exactly


@pytest.mark.parametrize("pyr_dtype", [torch.float32, torch.bfloat16])
def test_bf16_output_is_the_f32_result_rounded(rng, pyr_dtype):
    """`out_dtype=bfloat16` on the CPU: the f32 lookup cast to bf16 (round to
    nearest), bit for bit, as the kernel's bf16 output is; no launch."""
    tpyr, _, coords = _inputs(rng, 2, 5, 40, 40)
    tpyr = [c.to(pyr_dtype) for c in tpyr]
    x = torch.from_numpy(coords)
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(tpyr, x, out_dtype=torch.bfloat16)
    assert kl.corr_lookup_kernel.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kl.corr_lookup_kernel(tpyr, x).to(torch.bfloat16))


@pytest.mark.parametrize("pyr_dtype,out_dtype,size,out_size", [
    (torch.float32, torch.float32, 4, 4), (torch.bfloat16, torch.bfloat16, 2, 2),
    (torch.bfloat16, torch.float32, 2, 4)])
def test_lookup_bytes_count_the_taps_in_the_rows(pyr_dtype, out_dtype, size, out_size):
    """A pixel reads 2r + 2 neighbours per level where the row holds them,
    none past its ends; each at the pyramid's element size, the f32
    coordinates at 4 bytes and the output at its own."""
    pyramid = [torch.zeros(1, 1, 2, w, dtype=pyr_dtype) for w in (40, 20, 10, 5)]
    inside = torch.tensor([[[12.0, 20.0]]])  # levels at x 12/6/3/1.5 and 20/10/5/2.5
    # floor(x) - 4 .. floor(x) + 5 per level, clipped to the row: at x = 3 in
    # a row of 10, 0..8; at 1.5 in a row of 5, 0..4; at 5 in 10, 1..9
    reads = (10 + 10 + 9 + 5) + (10 + 10 + 9 + 5)
    pixels, out = 2, 2 * 36
    assert kl.corr_lookup_bytes(pyramid, inside, out_dtype=out_dtype) == (
        size * reads + 4 * pixels + out_size * out)
    far = torch.tensor([[[-100.0, 500.0]]])
    assert kl.corr_lookup_bytes(pyramid, far, out_dtype=out_dtype) == 4 * pixels + out_size * out


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w1,w2", [(10, 80, 128, 128), (3, 7, 45, 45)])
@pytest.mark.parametrize("pyr_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_kernel_matches_plain_on_card(n, h, w1, w2, pyr_dtype, out_dtype):
    """Kernel 6 repeats the plain version's operations in its order with
    round-to-nearest intrinsics and rounds a bf16 output as `.to()` does, so
    it equals the plain version bit for bit (and is within a few f32 ulps,
    the limit the fractional weights swapped fail). A pyramid of another
    dtype, and a pyramid that requires a gradient, are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    gen = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
    f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
    pyramid = [c.reshape(n, h, w1, -1).contiguous().to(pyr_dtype)
               for c in build_corr_pyramid(f1, f2, 4)]
    coords = torch.rand(n, h, w1, generator=gen, device="cuda") * (w2 + 24) - 12
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(pyramid, coords, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kl.corr_lookup_kernel.launches == before + 1
    assert got.dtype == out_dtype
    want = corr_lookup(pyramid, coords).to(out_dtype)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 2**-21 * want.float().abs().max().item()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kl.corr_lookup_kernel([p.double() for p in pyramid], coords)
    with pytest.raises(ValueError, match="gradient"):
        kl.corr_lookup_kernel([p.float().requires_grad_() for p in pyramid], coords)
