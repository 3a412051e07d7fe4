"""PPMStereo-VDA (`PPMStereoConfig(use_vfm=True, use_cnet=True)`) through the
port and the JAX package: the VFM encoders `BasicEncoderVFM` and
`MultiLevelEncoderVFM`, the whole model in test mode (disparity and
uncertainty, and the top-k picks) and train mode, `model_zoo(
"PPMStereoVDAModel")` against the JAX zoo on a 12-frame clip, and the
window modes the model cannot run, in f32.

Weights: the JAX package's `jax.jit(init)` parameters carried across
(tests/torch_config_parity.py: every play blend `beta` 1, the SST time
embedding drawn), with the backbone's motion modules' `proj_out` drawn
(zero at init). Input: 64x128 (the JAX zoo's init size; the ConvNeXt
context net needs heights of a multiple of 32), which the backbone sees at
56x126.

Limits: tests/test_torch_model.py's, 1e-4 px on the disparity and 3e-6 on
the uncertainty; 1e-5 relative to the largest magnitude on the encoders'
maps. Each test has a fault reading above its limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu.nn import encoder as jenc
from ppmstereo_tpu_torch.kernels import corr_lookup as tkl
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.nn import encoder as tenc
from ppmstereo_tpu_torch.ops.corr import corr_lookup
from ppmstereo_tpu_torch.utils.weights import flatten_params
from tests import torch_config_parity as cp
from tests.test_torch_vda import draw_proj_out, rel_diff
from tests.torch_zoo_parity import carried, jax_apply, jax_init, max_diff, port_apply, stereo_clip

torch.set_num_threads(1)
T, H, W, ITERS = 4, 64, 128, 2
KWARGS = dict(use_vfm=True, use_cnet=True, top_k=2)
BLOCK_REL = 1e-5


def _vfm_pyramid(rng, n: int, h: int, w: int, dim: int) -> list:
    return [rng.normal(size=(n, h // s, w // s, dim)).astype(np.float32)
            for s in (4, 8, 16, 32)]


def test_basic_encoder_vfm():
    """The VFM features joined before the output conv; the fault: the VFM
    features dropped (zeros)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    vfm = rng.normal(size=(2, 8, 12, 24)).astype(np.float32)
    jm = jenc.BasicEncoderVFM(output_dim=64)
    tree = jax_init(jm, x, vfm)
    want = jax_apply(jm, tree, x, vfm)
    model = carried(tenc.BasicEncoderVFM(64, vfm_dim=24), tree)
    got = port_apply(model, x, vfm)
    assert got.shape == want.shape == (2, 8, 12, 64)
    assert rel_diff(got, want) <= BLOCK_REL
    assert rel_diff(port_apply(model, x, np.zeros_like(vfm)), want) > BLOCK_REL


def test_multilevel_encoder_vfm():
    """(f4, f8, f16) of 2 frames at 64x96 with a 64-channel VFM pyramid;
    the fault: the pyramid's 1/8 and 1/16 maps swapped in their roles."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    vfm = _vfm_pyramid(rng, 2, 64, 96, 64)
    jm = jenc.MultiLevelEncoderVFM(output_dim=96)
    jvfm = [jnp.asarray(v) for v in vfm]
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                               jnp.asarray(x), jvfm))
    want = [np.asarray(f) for f in jax.jit(jm.apply)(tree, jnp.asarray(x), jvfm)]
    model = carried(tenc.MultiLevelEncoderVFM(96, vfm_dim=64), tree)
    with torch.no_grad():
        got = [f.numpy() for f in model(torch.from_numpy(x), [torch.from_numpy(v) for v in vfm])]
    shapes = [(2, 16, 24, 96), (2, 8, 12, 96), (2, 4, 6, 96)]
    assert [g.shape for g in got] == [w.shape for w in want] == shapes
    for g, w in zip(got, want):
        assert rel_diff(g, w) <= BLOCK_REL
    wrong = [torch.from_numpy(v) for v in vfm]
    wrong[1] = torch.nn.functional.interpolate(wrong[2].movedim(-1, 1), scale_factor=2.0
                                               ).movedim(1, -1)
    with torch.no_grad():
        assert rel_diff(model(torch.from_numpy(x), wrong)[0].numpy(), want[0]) > BLOCK_REL


@pytest.fixture(scope="module")
def setup():
    left, right = cp.clip(T, H, W, seed=3)
    tree = draw_proj_out(cp.jax_params(KWARGS, left, right, ITERS), seed=3)
    return left, right, tree


def test_vda_model_test_mode(setup, monkeypatch):
    """Disparity, uncertainty and every iteration's top-k picks; the model
    holds the backbone and the VFM encoder in fnet's place; the fault: the
    plain lookup read one pixel to the right."""
    left, right, tree = setup
    jax_picks = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda idx: jax_picks.append(np.asarray(idx)), out[1], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jd, ju = cp.run_jax(KWARGS, tree, left, right, ITERS, test_mode=True)
    jax.effects_barrier()
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=True)
    assert isinstance(model.fnet, tenc.MultiLevelEncoderVFM) and hasattr(model, "backbone")
    port_picks = []
    td, tu = cp.run_port(model, left, right, picks=port_picks)
    assert len(jax_picks) == len(port_picks) == 4  # 1 + 1 + 2 iterations
    for jp, tp in zip(jax_picks, port_picks):
        np.testing.assert_array_equal(tp.numpy(), jp)
    assert td.shape == jd.shape == (1, T, H, W, 1) and np.isfinite(td).all()
    np.testing.assert_allclose(td, jd, rtol=0, atol=cp.DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=cp.UNC_TOL)
    monkeypatch.setattr(tkl, "corr_lookup", lambda pyr, x, radius: corr_lookup(pyr, x + 1.0,
                                                                                radius))
    fd, _ = cp.run_port(model, left, right)
    assert np.abs(fd - jd).max() > cp.DISP_TOL


def test_vda_model_train_mode(setup, monkeypatch):
    """Every iteration's full-resolution prediction and uncertainty (1 + 1 +
    2); the fault: the 1/8 stage fed fnet's averaged 1/4 map in place of
    the VFM encoder's own 1/8 map (the path without use_vfm)."""
    left, right, tree = setup
    jp, ju = cp.run_jax(KWARGS, tree, left, right, ITERS, test_mode=False)
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=False)
    tp, tu = cp.run_port(model, left, right)
    assert tp.shape == jp.shape == (4, 1, T, H, W, 1)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=cp.DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=cp.UNC_TOL)
    vfm_features = tppm.PPMStereo._vfm_features

    def averaged_f8(self, image1, image2):
        feats, vfm = vfm_features(self, image1, image2)
        vfm["f8"] = tuple(tppm.avg_pool2d(feats[k], 2) for k in ("fmap1", "fmap2"))
        return feats, vfm

    monkeypatch.setattr(tppm.PPMStereo, "_vfm_features", averaged_f8)
    fp, _ = cp.run_port(model, left, right)
    assert np.abs(fp - jp).max() > cp.DISP_TOL


def test_zoo_matches_jax_zoo(setup, monkeypatch):
    """A 12-frame clip through both zoos (window 6, the shipped top_k 5:
    three strict windows), disparity and uncertainty."""
    _, _, tree = setup
    _, _, video = stereo_clip(12, H, W, seed=1)
    kwargs = dict(kernel_size=6, iters=ITERS, mixed_precision=False)
    want = jmodel_zoo("PPMStereoVDAModel", params=tree, force_xla_attention=True,
                      num_frames=T, **kwargs)({"stereo_video": video})
    pred = tmodel_zoo("PPMStereoVDAModel", params=flatten_params(tree), device="cpu",
                      num_frames=T, **kwargs)
    got = pred({"stereo_video": video})
    assert sorted(got) == sorted(want) == ["disparity", "uncertainties"]
    assert got["disparity"].shape == want["disparity"].shape == (12, H, W, 1)
    assert max_diff(got["disparity"], want["disparity"]) <= cp.DISP_TOL
    assert max_diff(got["uncertainties"], want["uncertainties"]) <= cp.UNC_TOL
    monkeypatch.setattr(tkl, "corr_lookup", lambda pyr, x, radius: corr_lookup(pyr, x + 1.0,
                                                                                radius))
    assert max_diff(pred({"stereo_video": video})["disparity"], want["disparity"]) > cp.DISP_TOL


def test_refused_window_modes(setup):
    """No per-frame encoders: the warm start and the encoder cache raise in
    `model_zoo` (the JAX zoo takes neither), `encode_frames` and
    `forward(feats=)` raise (as in the JAX model); a backbone the VDA table
    lacks is refused."""
    left, right, tree = setup
    for bad in ({"warm_start": True}, {"warm_iters": 2}, {"encoder_cache": True}):
        with pytest.raises(ValueError, match="use_vfm"):
            tmodel_zoo("PPMStereoVDAModel", device="cpu", iters=1, **bad)
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=True)
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    with pytest.raises(ValueError, match="encode_frames does not support use_vfm"):
        model.encode_frames(l, r)
    with pytest.raises(ValueError, match="feats= does not support use_vfm"):
        model(l, r, feats={})
    with pytest.raises(ValueError, match="vfm_encoder"):
        tppm.PPMStereoConfig(use_vfm=True, vfm_encoder="vitb")
    assert tppm.PPMStereoConfig(use_vfm=True, vfm_encoder="vitl").use_vfm
