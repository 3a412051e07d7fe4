"""The port's BiDAStereo against the JAX package's: the 2-D bilinear
sampler, TFCL and the flow warp, the update cell, the whole model with the
RAFT flows given and computed by its frozen RAFT, and
`model_zoo("BiDAStereoModel")` against the JAX zoo, in f32 (BiDAStereo's
shipped precision).

Weights: the update cell's JAX `jax.jit(init)` parameters carried across
with `utils/weights.py`; the whole model's the port's initialisation, its
variables checked against the JAX model's (`checked_port_init`); the RAFT's
FrozenBatchNorms given drawn statistics.
Inputs: seeded numpy arrays and the JAX package's synthetic clips.

Tolerance: 1e-4 px on the disparity (tests/torch_zoo_parity.DISP_TOL;
measured on the CPU: at most 1.4e-6 px; the faults 1.2e-3 px and more), 1e-5
on the sampler's, TFCL's and the warp's outputs of order 1, 1e-4 on the
update cell's. `bilinear_sample_2d` is four gathers (no grid_sample); its
test places coordinates inside the image, on its last row and column and
outside it. Each test has a fault reading above its limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import bidastereo as jbida
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu.ops import corr as jcorr
from ppmstereo_tpu_torch.models import bidastereo as tbida
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.ops import corr as tcorr
from ppmstereo_tpu_torch.utils.weights import flatten_params
from tests.test_torch_raft import draw_batch_norms
from tests.torch_zoo_parity import (
    DISP_TOL,
    carried,
    checked_port_init,
    jax_apply,
    jax_init,
    max_diff,
    port_apply,
    stereo_clip,
)

torch.set_num_threads(1)
OP_TOL = 1e-5
BLOCK_TOL = 1e-4
CFG = dict(raft_iters=2)


@pytest.fixture(scope="module")
def bida():
    """BiDAStereo's parameters (the port's initialisation, its variables
    checked against the JAX model's: tests/torch_zoo_parity.py::
    checked_port_init; its RAFT's batch norms drawn) and a (1, 2, 64, 128)
    clip."""
    left, right, _ = stereo_clip(2, 64, 128, seed=3)
    tree = checked_port_init(
        jbida.BiDAStereo(cfg=jbida.BiDAStereoConfig(**CFG), iters=2, test_mode=True),
        tbida.BiDAStereo(tbida.BiDAStereoConfig(**CFG), 2, test_mode=True), left, right)
    return draw_batch_norms(tree, seed=2), left, right


def _both(fn_j, fn_t, *arrays):
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    got = fn_t(*[torch.from_numpy(a) for a in arrays]).numpy()
    return got, want


def test_bilinear_sample_2d_inside_border_and_outside():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    pts = np.array([[1.3, 2.7], [4.0, 3.0], [8.0, 5.0], [0.0, 0.0], [8.0, 2.4], [3.5, 5.0],
                    [7.6, 4.2], [-0.4, 2.0], [8.5, 1.0], [3.0, -0.7], [2.0, 5.3],
                    [-3.0, 1.0], [20.0, 30.0]], np.float32)
    coords = np.broadcast_to(pts[None, :, None], (2, len(pts), 1, 2)).copy()
    got, want = _both(jcorr.bilinear_sample_2d, tcorr.bilinear_sample_2d, img, coords)
    assert got.shape == want.shape == (2, len(pts), 1, 3)
    assert max_diff(got, want) <= OP_TOL
    assert np.abs(want[:, -2:]).max() == 0  # far outside: zero padding
    assert max_diff(got[:, 1, 0], img[:, 3, 4]) <= OP_TOL  # a pixel centre reads itself
    # the fault: half-pixel (align_corners=False) coordinates
    shifted, _ = _both(jcorr.bilinear_sample_2d, tcorr.bilinear_sample_2d, img, coords - 0.5)
    assert max_diff(shifted, want) > OP_TOL


@pytest.mark.parametrize("psize", [(1, 9), (3, 3)])
def test_tfcl_correlation(psize, monkeypatch):
    rng = np.random.default_rng(1)
    left = rng.normal(size=(2, 5, 11, 16)).astype(np.float32)
    rights = [rng.normal(size=(2, 5, 11, 16)).astype(np.float32) for _ in range(3)]
    want = np.asarray(jcorr.tfcl_correlation(jnp.asarray(left), [jnp.asarray(r) for r in rights],
                                             psize))
    got = tcorr.tfcl_correlation(torch.from_numpy(left), [torch.from_numpy(r) for r in rights],
                                 psize).numpy()
    assert got.shape == want.shape == (2, 5, 11, 27)
    assert max_diff(got, want) <= OP_TOL
    # the fault: zero padding in place of replicate
    monkeypatch.setattr(tcorr, "_edge_pad_hw",
                        lambda x, py, px: torch.nn.functional.pad(x, (0, 0, px, px, py, py)))
    wrong = tcorr.tfcl_correlation(torch.from_numpy(left), [torch.from_numpy(r) for r in rights],
                                   psize).numpy()
    assert max_diff(wrong, want) > OP_TOL


def test_flow_warp():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8, 12, 5)).astype(np.float32)
    flow = rng.normal(0, 3, (3, 8, 12, 2)).astype(np.float32)
    got, want = _both(jbida.flow_warp, tbida.flow_warp, x, flow)
    assert max_diff(got, want) <= OP_TOL
    wrong, _ = _both(jbida.flow_warp, tbida.flow_warp, x, -flow)  # the fault: the sign
    assert max_diff(wrong, want) > OP_TOL


def test_update_block_matches_jax():
    rng = np.random.default_rng(3)
    shape = (1, 3, 4, 8)
    net = np.tanh(rng.normal(size=(*shape, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(*shape, 128)), 0).astype(np.float32)
    corrs = rng.normal(size=(*shape, 27)).astype(np.float32)
    flow = rng.normal(0, 2, (*shape, 2)).astype(np.float32)
    mhs = rng.normal(size=(*shape, 48)).astype(np.float32)
    fw = rng.normal(0, 1.5, (1, 2, 4, 8, 2)).astype(np.float32)
    bw = rng.normal(0, 1.5, (1, 2, 4, 8, 2)).astype(np.float32)
    args = (net, inp, corrs, flow, mhs, fw, bw)
    jm = jbida.MultiSequenceUpdateBlock3D()
    tree = jax_init(jm, *args)
    jnet, jmask, jdelta, jmhs = jax_apply(jm, tree, *args)
    model = carried(tbida.MultiSequenceUpdateBlock3D(128, 27), tree)
    tnet, tdelta, tmhs = port_apply(model, *args)
    with torch.no_grad():
        tmask = model.get_mask(torch.from_numpy(tnet)).numpy()
    for got, want in ((tnet, jnet), (tdelta, jdelta), (tmhs, jmhs), (tmask, jmask)):
        assert got.shape == want.shape
        assert max_diff(got, want) <= BLOCK_TOL
    # the fault: the forward and backward flows swapped
    assert max_diff(port_apply(model, net, inp, corrs, flow, mhs, bw, fw)[2], jmhs) > BLOCK_TOL


def test_bidastereo_with_flows_given(bida, monkeypatch):
    """The RAFT flows handed in (`flows=`, as the JAX entry point takes
    them)."""
    tree, left, right = bida
    rng = np.random.default_rng(4)
    flows = tuple(rng.normal(0, 2, (1, 1, 16, 32, 2)).astype(np.float32) for _ in range(2))
    jm = jbida.BiDAStereo(cfg=jbida.BiDAStereoConfig(**CFG), iters=2, test_mode=True)
    want = np.asarray(jax_apply(jm, tree, left, right, flows=tuple(map(jnp.asarray, flows))))
    model = carried(tbida.BiDAStereo(tbida.BiDAStereoConfig(**CFG), 2, test_mode=True), tree)
    tflows = tuple(map(torch.from_numpy, flows))
    got = port_apply(model, left, right, flows=tflows)
    assert got.shape == want.shape == (1, 2, 64, 128, 1)
    assert max_diff(got, want) <= DISP_TOL
    # the fault: the patch not alternating (always (1, 9))
    tfcl = tbida.tfcl_correlation
    monkeypatch.setattr(tbida, "tfcl_correlation", lambda left, rights, psize: tfcl(
        left, rights, (1, 9)))
    assert max_diff(port_apply(model, left, right, flows=tflows), want) > DISP_TOL


def test_bidastereo_with_its_raft(bida, monkeypatch):
    """flows=None: the frozen RAFT computes the flows (held against the JAX
    model's `_compute_flows`), in test mode and in the train-mode stack."""
    tree, left, right = bida
    jm = jbida.BiDAStereo(cfg=jbida.BiDAStereoConfig(**CFG), iters=2, test_mode=True)
    model = carried(tbida.BiDAStereo(tbida.BiDAStereoConfig(**CFG), 2, test_mode=True), tree)
    want_flows = jax_apply(jm, tree, right, method="_compute_flows")
    with torch.no_grad():
        got_flows = [f.numpy() for f in model.compute_flows(torch.from_numpy(right))]
    for got, want in zip(got_flows, want_flows):
        assert got.shape == want.shape == (1, 1, 16, 32, 2)
        assert max_diff(got, want) <= DISP_TOL
    assert max_diff(got_flows[0], want_flows[1]) > DISP_TOL  # the directions tell apart
    want = jax_apply(jm, tree, left, right)
    got = port_apply(model, left, right)
    assert max_diff(got, want) <= DISP_TOL
    jtrain = jbida.BiDAStereo(cfg=jbida.BiDAStereoConfig(**CFG), iters=2, test_mode=False)
    want_train = jax_apply(jtrain, tree, left, right)
    train = carried(tbida.BiDAStereo(tbida.BiDAStereoConfig(**CFG), 2, test_mode=False), tree)
    got_train = port_apply(train, left, right)
    assert got_train.shape == want_train.shape == (4, 1, 2, 64, 128, 1)
    assert max_diff(got_train, want_train) <= DISP_TOL
    # the fault: every 2-channel (flow) resize negated, so the 1/8 stage
    # starts from the negated flow (the JAX model rescales it positively,
    # ppmstereo_tpu/models/bidastereo.py:299)
    interp = tbida.interp_bilinear
    monkeypatch.setattr(tbida, "interp_bilinear",
                        lambda x, hw: -interp(x, hw) if x.shape[-1] == 2 else interp(x, hw))
    assert max_diff(port_apply(model, left, right), want) > DISP_TOL


def test_zoo_matches_jax_zoo(bida, monkeypatch):
    """A 6-frame clip through both zoos (window 4: three windows); no
    uncertainty in the output."""
    tree, _, _ = bida
    _, _, video = stereo_clip(6, 64, 128, seed=5)
    kwargs = dict(kernel_size=4, iters=2, **CFG)
    want = jmodel_zoo("BiDAStereoModel", params=tree, **kwargs)({"stereo_video": video})
    pred = tmodel_zoo("BiDAStereoModel", params=flatten_params(tree), device="cpu", **kwargs)
    got = pred({"stereo_video": video})
    assert sorted(got) == sorted(want) == ["disparity"]
    assert got["disparity"].shape == want["disparity"].shape == (6, 64, 128, 1)
    assert max_diff(got["disparity"], want["disparity"]) <= DISP_TOL
    tfcl = tbida.tfcl_correlation
    monkeypatch.setattr(tbida, "tfcl_correlation", lambda left, rights, psize: tfcl(
        left, rights, (1, 9)))
    assert max_diff(pred({"stereo_video": video})["disparity"], want["disparity"]) > DISP_TOL


def test_clip_of_one_frame_raises():
    model = tbida.BiDAStereo(tbida.BiDAStereoConfig(**CFG), 1, test_mode=True)
    with pytest.raises(ValueError, match="2 or more frames"):
        model(torch.zeros(1, 1, 32, 64, 3), torch.zeros(1, 1, 32, 64, 3))
