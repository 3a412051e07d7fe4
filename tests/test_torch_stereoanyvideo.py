"""The port's StereoAnyVideo against the JAX package's: AAPC at both patch
shapes, channel for channel, the update cell, the whole model in test and
train mode at an even and an odd iteration count, and
`model_zoo("StereoAnyVideoModel")` against the JAX zoo, in f32 (its shipped
precision).

Weights: the update cell's test carries the JAX module's `jax.jit(init)`
parameters to the port with `utils/weights.py`; the whole-model tests carry
the port's seeded initialisation to the JAX model
(tests/torch_zoo_parity.py::port_init_tree). Both with the
zero-initialised leaves drawn (the motion modules' `proj_out`, the temporal
attention's `temporal_fc`). Inputs: seeded numpy arrays and the JAX
package's synthetic clips, at 64x128 (the VDA backbone sees 56x126).

Tolerance: 1e-4 px on the disparity (tests/torch_zoo_parity.DISP_TOL), 1e-5
relative to the largest magnitude on AAPC's and the update cell's outputs.
The whole model, measured on the CPU on the port's initialisation: at most
1.1e-6 px in test and train mode and 2.2e-6 px through the zoo; the faults
3.0e-2 px (test mode), 0.56 px (train mode) and 9.4e-2 px (zoo). The
whole-model tests record both as junit properties. Each test has a fault
reading above its limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import stereoanyvideo as jsav
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu.nn import update as jupdate
from ppmstereo_tpu.ops import corr as jcorr
from ppmstereo_tpu_torch.models import stereoanyvideo as tsav
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.nn import update as tupdate
from ppmstereo_tpu_torch.ops import corr as tcorr
from ppmstereo_tpu_torch.utils.weights import flatten_params
from tests.test_torch_vda import draw_proj_out, rel_diff
from tests.torch_zoo_parity import (
    DISP_TOL,
    carried,
    draw_zero_leaves,
    jax_apply,
    jax_init,
    max_diff,
    port_apply,
    port_init_tree,
    stereo_clip,
)

torch.set_num_threads(1)
BLOCK_REL = 1e-5


@pytest.mark.parametrize("psize", [(1, 9), (3, 3)])
def test_aapc_correlation(psize, monkeypatch):
    """All 4 x 81 channels against the JAX loop's, in its order (group, then
    the left shift, then the right shift); the faults: the two shifts'
    order swapped, and zero padding in place of replicate."""
    rng = np.random.default_rng(0)
    left = rng.normal(size=(2, 5, 11, 16)).astype(np.float32)
    right = rng.normal(size=(2, 5, 11, 16)).astype(np.float32)
    want = np.asarray(jcorr.aapc_correlation(jnp.asarray(left), jnp.asarray(right), psize))
    got = tcorr.aapc_correlation(torch.from_numpy(left), torch.from_numpy(right),
                                 psize).numpy()
    assert got.shape == want.shape == (2, 5, 11, 324)
    assert rel_diff(got, want) <= BLOCK_REL
    swapped = got.reshape(2, 5, 11, 4, 9, 9).swapaxes(-1, -2).reshape(got.shape)
    assert rel_diff(swapped, want) > BLOCK_REL
    monkeypatch.setattr(tcorr, "_edge_pad_hw",
                        lambda x, py, px: torch.nn.functional.pad(x, (0, 0, px, px, py, py)))
    wrong = tcorr.aapc_correlation(torch.from_numpy(left), torch.from_numpy(right),
                                   psize).numpy()
    assert rel_diff(wrong, want) > BLOCK_REL


def test_sav_update_block():
    """The cell's new state, delta and mask; the fault: the time attention
    skipped."""
    rng = np.random.default_rng(1)
    shape = (1, 3, 4, 8)
    net = np.tanh(rng.normal(size=(*shape, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(*shape, 128)), 0).astype(np.float32)
    corrs = rng.normal(size=(*shape, 128)).astype(np.float32)
    flow = rng.normal(0, 2, (*shape, 2)).astype(np.float32)
    jm = jupdate.SAVSequenceUpdateBlock3D()
    tree = draw_zero_leaves(jax_init(jm, net, inp, corrs, flow), seed=1)
    jnet, jmask, jdelta = jax_apply(jm, tree, net, inp, corrs, flow)
    model = carried(tupdate.SAVSequenceUpdateBlock3D(), tree)
    tnet, tdelta, tmask = port_apply(model, net, inp, corrs, flow, compute_mask=True)
    for got, want in ((tnet, jnet), (tdelta, jdelta), (tmask, jmask)):
        assert got.shape == want.shape
        assert rel_diff(got, want) <= BLOCK_REL
    model.time_attn.forward = lambda x: x
    assert rel_diff(port_apply(model, net, inp, corrs, flow)[0], jnet) > BLOCK_REL


@pytest.fixture(scope="module")
def sav():
    """StereoAnyVideo's parameters (the port's initialisation, zero leaves
    drawn) and a (1, 2, 64, 128) clip."""
    left, right, _ = stereo_clip(2, 64, 128, seed=3)
    tree = port_init_tree(tsav.StereoAnyVideo(iters=2, test_mode=True), seed=3)
    return draw_proj_out(draw_zero_leaves(tree, seed=3), seed=3), left, right


def _psize_fault(monkeypatch):
    """The fault: the patch not alternating (always (1, 9))."""
    aapc = tsav.aapc_correlation
    monkeypatch.setattr(tsav, "aapc_correlation", lambda l, r, psize: aapc(l, r, (1, 9)))


@pytest.mark.parametrize("iters", [2, 3])
def test_stereoanyvideo_test_mode(sav, iters, monkeypatch, record_property):
    tree, left, right = sav
    want = jax_apply(jsav.StereoAnyVideo(iters=iters, test_mode=True), tree, left, right)
    model = carried(tsav.StereoAnyVideo(iters=iters, test_mode=True), tree)
    got = port_apply(model, left, right)
    assert got.shape == want.shape == (1, 2, 64, 128, 1)
    assert np.isfinite(got).all()
    record_property("max_diff_px", max_diff(got, want))
    assert max_diff(got, want) <= DISP_TOL
    _psize_fault(monkeypatch)
    fault = max_diff(port_apply(model, left, right), want)
    record_property("fault_max_diff_px", fault)
    assert fault > DISP_TOL


@pytest.mark.parametrize("iters", [2, 3])
def test_stereoanyvideo_train_mode(sav, iters, monkeypatch, record_property):
    """Every iteration's full-resolution prediction: 2 (iters // 2) + iters
    of them; the fault: each stage starts from the negated flow of the one
    before (the JAX model rescales it positively between stages)."""
    tree, left, right = sav
    want = jax_apply(jsav.StereoAnyVideo(iters=iters, test_mode=False), tree, left, right)
    model = carried(tsav.StereoAnyVideo(iters=iters, test_mode=False), tree)
    got = port_apply(model, left, right)
    assert got.shape == want.shape == (2 * (iters // 2) + iters, 1, 2, 64, 128, 1)
    record_property("max_diff_px", max_diff(got, want))
    assert max_diff(got, want) <= DISP_TOL
    interp = tsav.interp_bilinear
    monkeypatch.setattr(tsav, "interp_bilinear", lambda x, hw: -interp(x, hw)
                        if x.shape[-1] == 2 and x.shape[2] < hw[0] else interp(x, hw))
    fault = max_diff(port_apply(model, left, right), want)
    record_property("fault_max_diff_px", fault)
    assert fault > DISP_TOL


def test_zoo_matches_jax_zoo(sav, monkeypatch, record_property):
    """A 6-frame clip through both zoos (window 4: three windows); no
    uncertainty in the output; `model_zoo` refuses the PPMStereo-only
    window modes."""
    tree, _, _ = sav
    _, _, video = stereo_clip(6, 64, 128, seed=5)
    kwargs = dict(kernel_size=4, iters=2)
    want = jmodel_zoo("StereoAnyVideoModel", params=tree, **kwargs)({"stereo_video": video})
    pred = tmodel_zoo("StereoAnyVideoModel", params=flatten_params(tree), device="cpu",
                      **kwargs)
    got = pred({"stereo_video": video})
    assert sorted(got) == sorted(want) == ["disparity"]
    assert got["disparity"].shape == want["disparity"].shape == (6, 64, 128, 1)
    record_property("max_diff_px", max_diff(got["disparity"], want["disparity"]))
    assert max_diff(got["disparity"], want["disparity"]) <= DISP_TOL
    for bad in ({"warm_start": True}, {"encoder_cache": True}):
        with pytest.raises(ValueError, match="encode_frames"):
            tmodel_zoo("StereoAnyVideoModel", device="cpu", iters=1, **bad)
    with pytest.raises(ValueError, match="encoder"):
        tsav.StereoAnyVideoConfig(encoder="vitg")
    _psize_fault(monkeypatch)
    fault = max_diff(pred({"stereo_video": video})["disparity"], want["disparity"])
    record_property("fault_max_diff_px", fault)
    assert fault > DISP_TOL
