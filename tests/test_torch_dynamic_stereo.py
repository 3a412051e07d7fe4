"""The port's DynamicStereo against the JAX package's: its GRU, motion
encoder and update cell, the whole model in test and train mode, and
`model_zoo("DynamicStereoModel")` over a clip, in f32.

Weights: the JAX modules' `jax.jit(init)` parameters carried across with
`utils/weights.py`, the time embedding and the temporal attention's output
projection drawn (tests/torch_zoo_parity.py). Inputs: seeded numpy arrays
and the JAX package's synthetic clips.

Tolerance: DISP_TOL = 1e-4 px on the disparity, as tests/test_torch_model.py
(measured on the CPU: 2.3e-6 px in test mode, 2.7e-6 in train mode, 2.6e-6
through the zoos); the blocks' outputs within 1e-4 of values of order 1.
Each model-level test has a fault reading above the limit: the coarser
stage's flow passed on with the sign the reference's quirk does not have
(ppmstereo_tpu/models/dynamic_stereo.py:202, :209).
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu.models.dynamic_stereo import DynamicStereo as JDynamicStereo
from ppmstereo_tpu.models.dynamic_stereo import DynamicStereoConfig as JConfig
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu.nn.gru import SepConvGRU3D as JSepConvGRU3D
from ppmstereo_tpu.nn.motion import BasicMotionEncoder as JBasicMotionEncoder
from ppmstereo_tpu.nn.update import DSSequenceUpdateBlock3D as JDSBlock
from ppmstereo_tpu_torch.models import dynamic_stereo as tds
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.nn.gru import SepConvGRU3D
from ppmstereo_tpu_torch.nn.motion import BasicMotionEncoder
from ppmstereo_tpu_torch.nn.update import DSSequenceUpdateBlock3D
from ppmstereo_tpu_torch.utils.weights import flatten_params, state_dict_to_flax
from tests.torch_zoo_parity import (
    DISP_TOL,
    carried,
    draw_zero_leaves,
    jax_apply,
    jax_init,
    max_diff,
    port_apply,
    stereo_clip,
)

torch.set_num_threads(1)
BLOCK_TOL = 1e-4
ATTENTION = tds.DS_ATTENTION


@pytest.fixture(scope="module")
def ds():
    """The JAX DynamicStereo's parameters and a (1, 3, 64, 128) clip."""
    left, right, _ = stereo_clip(3, 64, 128)
    tree = jax_init(JDynamicStereo(cfg=JConfig(mixed_precision=False), iters=2, test_mode=True),
                    left, right)
    return draw_zero_leaves(tree), left, right


def _flip_stage_sign(monkeypatch):
    """The fault: every 2-channel (flow) resize negated, so the coarser
    stage's flow reaches the next without the reference's negation."""
    interp = tds.interp_bilinear

    def flipped(x, hw):
        out = interp(x, hw)
        return -out if x.shape[-1] == 2 else out

    monkeypatch.setattr(tds, "interp_bilinear", flipped)


def test_sep_conv_gru3d_matches_jax():
    rng = np.random.default_rng(0)
    h = np.tanh(rng.normal(size=(1, 3, 6, 10, 128))).astype(np.float32)
    x = rng.normal(size=(1, 3, 6, 10, 256)).astype(np.float32)
    jm = JSepConvGRU3D(hidden_dim=128)
    tree = jax_init(jm, h, x)
    want = jax_apply(jm, tree, h, x)
    got = port_apply(carried(SepConvGRU3D(128, 256), tree), h, x)
    assert max_diff(got, want) <= BLOCK_TOL
    # the fault: the time pass's gates read the height pass's weights
    wrong = carried(SepConvGRU3D(128, 256), tree)
    for i in range(3):
        getattr(wrong, f"Conv_{6 + i}").Conv_0.weight.data = \
            getattr(wrong, f"Conv_{3 + i}").Conv_0.weight.data.permute(0, 1, 3, 2, 4).clone()
    assert max_diff(port_apply(wrong, h, x), want) > BLOCK_TOL


@pytest.mark.parametrize("corr_act", ["gelu", "relu"])
def test_basic_motion_encoder_matches_jax(corr_act):
    rng = np.random.default_rng(1)
    flow = rng.normal(0, 3, (1, 2, 8, 12, 2)).astype(np.float32)
    corr = rng.normal(size=(1, 2, 8, 12, 36)).astype(np.float32)
    jm = JBasicMotionEncoder(corr_act=corr_act)
    tree = jax_init(jm, flow, corr)
    want = jax_apply(jm, tree, flow, corr)
    got = port_apply(carried(BasicMotionEncoder(36, corr_act), tree), flow, corr)
    assert got.shape == want.shape == (1, 2, 8, 12, 128)
    assert max_diff(got, want) <= BLOCK_TOL
    other = "relu" if corr_act == "gelu" else "gelu"
    wrong = port_apply(carried(BasicMotionEncoder(36, other), tree), flow, corr)
    assert max_diff(wrong, want) > BLOCK_TOL


@pytest.mark.parametrize("attention_type", [None, ATTENTION])
def test_ds_update_block_matches_jax(attention_type):
    rng = np.random.default_rng(2)
    shape = (1, 3, 4, 8)
    net = np.tanh(rng.normal(size=(*shape, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(*shape, 128)), 0).astype(np.float32)
    corrs = rng.normal(size=(*shape, 36)).astype(np.float32)
    flow = rng.normal(0, 2, (*shape, 2)).astype(np.float32)
    jm = JDSBlock(attention_type=attention_type)
    tree = draw_zero_leaves(jax_init(jm, net, inp, corrs, flow))
    jnet, jmask, jdelta = jax_apply(jm, tree, net, inp, corrs, flow)
    tm = carried(DSSequenceUpdateBlock3D(128, 36, attention_type), tree)
    tnet, tdelta, tmask = port_apply(tm, net, inp, corrs, flow, compute_mask=True)
    assert tmask.shape == jmask.shape == (*shape, 144)
    for got, want in ((tnet, jnet), (tdelta, jdelta), (tmask, jmask)):
        assert max_diff(got, want) <= BLOCK_TOL
    with torch.no_grad():
        m2 = tm.get_mask(torch.from_numpy(tnet)).numpy()
    assert max_diff(m2, jmask) <= BLOCK_TOL
    if attention_type is not None:
        # the fault: the attention left out
        bare = carried(DSSequenceUpdateBlock3D(128, 36, None),
                       {"params": {k: v for k, v in tree["params"].items()
                                   if k not in ("time_attn", "space_attn")}})
        assert max_diff(port_apply(bare, net, inp, corrs, flow)[1], jdelta) > BLOCK_TOL


def test_dynamic_stereo_test_mode_matches_jax(ds, monkeypatch):
    tree, left, right = ds
    want = jax_apply(JDynamicStereo(cfg=JConfig(mixed_precision=False), iters=2,
                                    test_mode=True), tree, left, right)
    model = carried(tds.DynamicStereo(tds.DynamicStereoConfig(mixed_precision=False), 2,
                                      test_mode=True), tree)
    got = port_apply(model, left, right)
    assert got.shape == want.shape == (1, 3, 64, 128, 1)
    assert np.isfinite(got).all()
    assert max_diff(got, want) <= DISP_TOL
    _flip_stage_sign(monkeypatch)
    assert max_diff(port_apply(model, left, right), want) > DISP_TOL


def test_dynamic_stereo_train_mode_matches_jax(ds, monkeypatch):
    """Every iteration's full-resolution prediction (1 + 1 + 2)."""
    tree, left, right = ds
    want = jax_apply(JDynamicStereo(cfg=JConfig(mixed_precision=False), iters=2,
                                    test_mode=False), tree, left, right)
    model = carried(tds.DynamicStereo(tds.DynamicStereoConfig(mixed_precision=False), 2,
                                      test_mode=False), tree)
    got = port_apply(model, left, right)
    assert got.shape == want.shape == (4, 1, 3, 64, 128, 1)
    assert max_diff(got, want) <= DISP_TOL
    _flip_stage_sign(monkeypatch)
    assert max_diff(port_apply(model, left, right), want) > DISP_TOL


def test_zoo_matches_jax_zoo_fast_batched(ds, monkeypatch):
    """A 12-frame clip through both zoos with fast_mode and batch_windows=2
    (windows of 4 frames: a batch of two, then one); no uncertainty in the
    output, as in the JAX wrapper."""
    tree, _, _ = ds
    _, _, video = stereo_clip(12, 64, 128, seed=1)
    kwargs = dict(kernel_size=4, iters=2, mixed_precision=False, fast_mode=True,
                  batch_windows=2)
    want = jmodel_zoo("DynamicStereoModel", params=tree, **kwargs)(
        {"stereo_video": video})
    pred = tmodel_zoo("DynamicStereoModel", params=flatten_params(tree), device="cpu",
                      **kwargs)
    got = pred({"stereo_video": video})
    assert sorted(got) == sorted(want) == ["disparity"]
    assert got["disparity"].shape == want["disparity"].shape == (12, 64, 128, 1)
    assert max_diff(got["disparity"], want["disparity"]) <= DISP_TOL
    _flip_stage_sign(monkeypatch)
    assert max_diff(pred({"stereo_video": video})["disparity"], want["disparity"]) > DISP_TOL


def test_refusals():
    """different_update_blocks=False raises, as in the JAX package; a warm
    start or the encoder cache raises for a model without PPMStereo's
    encoder split (the JAX wrapper cannot run them for the baselines)."""
    with pytest.raises(NotImplementedError, match="shared update blocks"):
        tds.DynamicStereoConfig(different_update_blocks=False)
    for kwargs in ({"warm_start": True}, {"warm_iters": 2}, {"encoder_cache": True}):
        with pytest.raises(ValueError, match="encode_frames"):
            tmodel_zoo("DynamicStereoModel", device="cpu", iters=1, **kwargs)


def test_carry_round_trip(ds):
    """The carried parameters written back in the flax layout are the JAX
    tree's, leaf for leaf (each tensor transposed once each way)."""
    tree, _, _ = ds
    model = carried(tds.DynamicStereo(tds.DynamicStereoConfig(mixed_precision=False), 2,
                                      test_mode=True), tree)
    back = state_dict_to_flax(model.state_dict())
    flat = flatten_params(tree)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
