"""The pyramid lookup, kernel 6's plain version (`ops/corr.py::corr_lookup`,
which `kernels/corr_lookup.py::corr_lookup_kernel` takes for CPU tensors),
against the JAX package's Pallas lookup kernel in interpret mode and its
XLA lookup, on the same pyramid and coordinates; and the CUDA kernel
against the plain version on a card (`cuda`-marked; skips without one).

Tolerance 1e-6: every output is a(1 - f) + b f of two pyramid values in f32
in all three (the Pallas kernel's one-hot sum adds only zeros besides the
two taps), so they agree to a rounding or two of values below ~10.
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


def test_lookup_bytes_count_the_taps_in_the_rows():
    """A pixel reads 2r + 2 neighbours per level where the row holds them,
    none past its ends."""
    pyramid = [torch.zeros(1, 1, 2, w) for w in (40, 20, 10, 5)]
    inside = torch.tensor([[[12.0, 20.0]]])  # levels at x 12/6/3/1.5 and 20/10/5/2.5
    # floor(x) - 4 .. floor(x) + 5 per level, clipped to the row: at x = 3 in
    # a row of 10, 0..8; at 1.5 in a row of 5, 0..4; at 5 in 10, 1..9
    reads = (10 + 10 + 9 + 5) + (10 + 10 + 9 + 5)
    pixels, out = 2, 2 * 36
    assert kl.corr_lookup_bytes(pyramid, inside) == 4.0 * (reads + pixels + out)
    far = torch.tensor([[[-100.0, 500.0]]])
    assert kl.corr_lookup_bytes(pyramid, far) == 4.0 * (pixels + out)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w1,w2", [(10, 80, 128, 128), (3, 7, 45, 45)])
def test_kernel_matches_plain_on_card(n, h, w1, w2):
    """Kernel 6 repeats the plain version's operations in its order with
    round-to-nearest intrinsics: a few f32 ulps at most (chip_smoke.py reads
    0.0); the fractional weights swapped fail that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    gen = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
    f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
    pyramid = [c.reshape(n, h, w1, -1).contiguous() for c in build_corr_pyramid(f1, f2, 4)]
    coords = torch.rand(n, h, w1, generator=gen, device="cuda") * (w2 + 24) - 12
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(pyramid, coords)
    torch.cuda.synchronize()
    assert kl.corr_lookup_kernel.launches == before + 1
    want = corr_lookup(pyramid, coords)
    assert (got - want).abs().max().item() <= 2**-21 * want.abs().max().item()
    with pytest.raises(ValueError, match="float32"):
        kl.corr_lookup_kernel([p.double() for p in pyramid], coords)
