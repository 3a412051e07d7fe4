"""What `PPMStereoConfig`'s switches reach below the model, and what the port
refuses:

  * `ops/upsample.py::convex_upsample_2d` (`use_convex_3d=False`) against the
    JAX package's, to 1e-6 absolute and relative (both a softmax-weighted
    sum of 9 f32 values of up to ~10: an f32 rounding or two);
  * kernel 6's plain version (`ops/corr.py::corr_lookup`, which the kernel's
    wrapper takes for CPU tensors) at radius 2 and 3 and 3 levels against
    the JAX package's Pallas lookup in interpret mode and its XLA lookup,
    with tests/test_torch_corr_lookup.py's limit (1e-6), and the kernel on a
    card at every radius and level count it is built for, bit for bit
    (`cuda`-marked);
  * the play's head dim: on the CPU any head dim takes the plain play; on a
    card the kernels take D = 128 and any other head dim raises;
  * each configuration the port refuses raises when it is built, naming
    why.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.kernels.corr_lookup import corr_lookup_pallas
from ppmstereo_tpu.ops import corr as jcorr
from ppmstereo_tpu.ops import upsample as jup
from ppmstereo_tpu_torch.kernels import corr_lookup as kl
from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_2d

torch.set_num_threads(1)


def test_convex_upsample_2d_matches_jax(rng):
    flow = rng.standard_normal((3, 6, 10, 2)).astype(np.float32)
    mask = (2 * rng.standard_normal((3, 6, 10, 9 * 16))).astype(np.float32)
    got = convex_upsample_2d(torch.from_numpy(flow), torch.from_numpy(mask), rate=4).numpy()
    want = np.asarray(jup.convex_upsample_2d(jnp.asarray(flow), jnp.asarray(mask), rate=4))
    assert got.shape == want.shape == (3, 24, 40, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() > 1.0


@pytest.mark.parametrize("radius,levels", [(2, 4), (3, 3), (3, 4)])
def test_lookup_radius_and_levels_match_jax(rng, radius, levels):
    b, h, w1, w2 = 2, 9, 48, 48
    f1 = rng.standard_normal((b, h, w1, 16)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w2, 16)).astype(np.float32)
    coords = (np.arange(w1, dtype=np.float32)
              + rng.standard_normal((b, h, w1)).astype(np.float32) * 0.3 * w2)
    tpyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), levels)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(tpyr, torch.from_numpy(coords), radius).numpy()
    assert kl.corr_lookup_kernel.launches == before
    assert got.shape == (b, h, w1, levels * (2 * radius + 1))
    pallas = np.asarray(corr_lookup_pallas(jpyr, jnp.asarray(coords), radius, interpret=True))
    xla = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), radius, impl="gather"))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    assert (got == 0).any() and (got != 0).mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("radius", range(1, kl.MAX_RADIUS + 1))
@pytest.mark.parametrize("pyr_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_kernel_every_radius_and_level_count_on_card(radius, pyr_dtype, out_dtype):
    """Kernel 6 at each radius and 1 to MAX_LEVELS levels equals the plain
    lookup bit for bit; a radius or a level count past the kernel's raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    n, h, w1, w2 = 3, 7, 90, 90
    gen = torch.Generator(device="cuda").manual_seed(radius)
    f1 = torch.randn(n * h, 1, w1, 32, generator=gen, device="cuda")
    f2 = torch.randn(n * h, 1, w2, 32, generator=gen, device="cuda")
    full = [c.reshape(n, h, w1, -1).contiguous().to(pyr_dtype)
            for c in build_corr_pyramid(f1, f2, kl.MAX_LEVELS)]
    coords = torch.rand(n, h, w1, generator=gen, device="cuda") * (w2 + 24) - 12
    for levels in range(1, kl.MAX_LEVELS + 1):
        pyramid = full[:levels]
        got = kl.corr_lookup_kernel(pyramid, coords, radius, out_dtype=out_dtype)
        assert torch.equal(got, corr_lookup(pyramid, coords, radius).to(out_dtype))
    with pytest.raises(ValueError, match="radius"):
        kl.corr_lookup_kernel(full, coords, kl.MAX_RADIUS + 1)
    with pytest.raises(ValueError, match="levels"):
        kl.corr_lookup_kernel(full + full[-1:], coords, radius)


def test_head_dim_not_a_multiple_of_128_takes_the_plain_play(rng):
    q = torch.from_numpy(rng.standard_normal((2, 10, 64)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 30, 64)).astype(np.float32)).bfloat16()
    before = tpa.play_attention.launches
    out = tpa.play_attention(q, k, k, 0.1)
    assert tpa.play_attention.launches == before
    assert torch.equal(out, tpa.play_attention_plain(q, k, k, 0.1))


@pytest.mark.cuda
def test_head_dim_routing_on_card():
    """On a card a head dim other than 128 (64 or 256) raises in kernel 1,
    in the training kernels and in the ring hop, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counters = (tpa.play_attention, tpa.play_attention_fwd_res, tpa.play_attention_carry)
    before = [c.launches for c in counters]
    for d in (64, 256):
        q = torch.randn(2, 100, d, device="cuda").bfloat16()
        k = torch.randn(2, 300, d, device="cuda").bfloat16()
        with pytest.raises(ValueError, match="takes"):
            tpa.play_attention(q, k, k, 0.1)
        with pytest.raises(ValueError, match="takes"):
            tpa.play_attention(q.clone().requires_grad_(), k, k, 0.1)
        o = torch.zeros(2, 100, d, device="cuda")
        m = torch.full((2, 100), -float("inf"), device="cuda")
        with pytest.raises(ValueError, match="takes"):
            tpa.play_attention_carry(q, k, k, o, m, torch.zeros_like(m), 0.1)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("kwargs,error,match", [
    ({"different_update_blocks": False}, NotImplementedError, "shared update blocks"),
    ({"use_vfm": True, "vfm_encoder": "vitb"}, ValueError, "Video-Depth-Anything has"),
    ({"vfm_encoder": "vitg"}, ValueError, "Video-Depth-Anything has"),
    ({"corr_radius": kl.MAX_RADIUS + 1}, ValueError, "kernel 6"),
    ({"corr_levels": kl.MAX_LEVELS + 1}, ValueError, "kernel 6"),
    ({"corr_radius": 0}, ValueError, "kernel 6"),
    ({"context_dim": 256}, ValueError, r"D = 128 \(ROADMAP"),
    ({"context_dim": 64}, ValueError, "head dim must be 128"),
    ({"hidden_dim": 64, "dim": 128}, ValueError, "384 channels"),
])
def test_refused_configurations_raise_when_built(kwargs, error, match):
    with pytest.raises(error, match=match):
        PPMStereoConfig(**kwargs)


def test_accepted_no_op_switches():
    """remat, ring_attention and unroll_refinement_loop are accepted;
    force_xla_attention runs the plain play on the CPU (its route anyway)
    and raises on a card."""
    cfg = PPMStereoConfig(remat=False, ring_attention=False, unroll_refinement_loop=True,
                          force_xla_attention=True, mixed_precision=False)
    model = PPMStereo(cfg, iters=1, test_mode=True)
    video = torch.rand(1, 2, 32, 64, 3) * 255
    with torch.no_grad():
        disp, _ = model(video, video)
    assert disp.shape == (1, 2, 32, 64, 1) and torch.isfinite(disp).all()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="force_xla_attention"), torch.no_grad():
            model.cuda()(video.cuda(), video.cuda())
