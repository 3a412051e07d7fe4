"""The forward entries of the window modes, `PPMStereo.forward(feats=)` and
`forward(flow_init=, warm_iters=)`, and the predictor's trim and alignment
helpers, against the JAX package's.

Weights: the committed anchor, carried into the port. Tolerance: as in
tests/test_torch_model.py (f32 except the play step's bf16 q/k/v; the port
differs from the JAX package by about 1e-5 px of disparity, a wrong play
step by at least 6.9e-4 px; limits 1e-4 px and 3e-6 of uncertainty).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import inference as jinf
from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JConfig
from ppmstereo_tpu_torch.models import inference as tinf
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.utils.weights import load_flax_params
from tests.torch_parity_data import load_anchor, synthetic_clip

torch.set_num_threads(1)
DISP_TOL = 1e-4
UNC_TOL = 3e-6
ITERS, WARM_ITERS = 2, 1


@pytest.fixture(scope="module")
def anchor():
    return load_anchor()


def test_trim_bounds_of_fast_windows_match_jax():
    for k in (4, 5, 6, 10):
        for i in range(0, 40, k):
            for wlen in range(1, k + 1):
                assert tinf.window_trim_bounds(i, wlen, k, k, fast_mode=True) == \
                    jinf.window_trim_bounds(i, wlen, k, k, fast_mode=True) == (0, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_shift_align_matches_jax(seed):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 50, (3, 8, 9, 1)).astype(np.float32)
    new = (0.8 * prev + 3.0 + rng.normal(0, 0.1, prev.shape)).astype(np.float32)
    if seed == 2:
        new = np.full_like(prev, 7.0)  # no variance: the shift alone
    got, want = tinf.scale_shift_align(prev, new), jinf.scale_shift_align(prev, new)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if seed < 2:
        assert abs(got[0] - 1.25) < 0.01 and abs(got[1] + 3.75) < 0.1


@pytest.fixture(scope="module")
def entry_clip():
    video, gt = synthetic_clip(5, 64, 128, seed=3)
    return video[None, :, 0], video[None, :, 1], gt


def test_forward_with_feats_matches_jax(anchor, entry_clip):
    """forward(feats=) with the features of `encode_frames` against the JAX
    model's `__call__(feats=)`; in the port it equals the plain forward bit
    for bit."""
    flat, tree = anchor
    left, right, _ = entry_clip
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                    iters=ITERS, test_mode=True)
    jl, jr = jnp.asarray(left), jnp.asarray(right)

    def jfwd(params, l, r):
        feats = jm.apply(params, l, r, method="encode_frames")
        return jm.apply(params, l, r, feats=feats)

    jd, ju = (np.asarray(x) for x in jax.jit(jfwd)(tree, jl, jr))
    tm = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=ITERS,
                         test_mode=True)
    load_flax_params(tm, flat)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    with torch.no_grad():
        feats = tm.encode_frames(tl, tr)
        assert set(feats) == {"fmap1", "fmap2", "cnet4", "cnet8", "cnet16"}
        td, tu = tm(tl, tr, feats=feats)
        pd, pu = tm(tl, tr)
    assert torch.equal(td, pd) and torch.equal(tu, pu)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=DISP_TOL)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=UNC_TOL)


def test_forward_with_flow_init_matches_jax(anchor, entry_clip):
    """forward(flow_init=, warm_iters=1) of a 2-iteration model against the
    JAX warm model of 1 iteration (the zoo builds a second JAX module of
    warm_iters; the port shares its parameters and takes the count as an
    argument): disparity, uncertainty and the picks. The seed is the clip's
    signed disparity perturbed by up to 2 px."""
    flat, tree = anchor
    left, right, gt = entry_clip
    rng = np.random.default_rng(4)
    flow_init = (-(gt + rng.uniform(-2, 2, gt.shape))).astype(np.float32)[None, ..., None]
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                    iters=WARM_ITERS, test_mode=True)
    jd, ju = (np.asarray(x) for x in jax.jit(
        lambda p, l, r, f: jm.apply(p, l, r, flow_init=f))(
        tree, jnp.asarray(left), jnp.asarray(right), jnp.asarray(flow_init)))
    tm = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=ITERS,
                         test_mode=True)
    load_flax_params(tm, flat)
    picks: list = []
    with torch.no_grad():
        td, tu = tm(torch.from_numpy(left), torch.from_numpy(right),
                    flow_init=torch.from_numpy(flow_init), warm_iters=WARM_ITERS, picks=picks)
    assert len(picks) == WARM_ITERS  # the 1/4 loop alone
    assert td.shape == (1, 5, 64, 128, 1) and tu.shape == (1, 5, 64, 128, 1)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=DISP_TOL)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=UNC_TOL)
    with pytest.raises(ValueError, match="flow_init"):
        tm(torch.from_numpy(left), torch.from_numpy(right), warm_iters=1)
