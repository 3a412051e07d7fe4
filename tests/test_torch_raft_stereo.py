"""The port's RAFT-Stereo against the JAX package's, against a torch
RAFT-Stereo with the reference's state-dict layout (tests/
raftstereo_torch_stub.py) brought in through the port's
`raftstereo_mapping`, and `model_zoo("RAFTStereoModel")` against the JAX
zoo, in f32 (RAFT-Stereo's shipped precision).

Weights: the port's initialisation carried across with `utils/weights.py`,
its variables checked against the JAX model's (`jax.eval_shape` of its
init: tests/torch_zoo_parity.py::checked_port_init), every FrozenBatchNorm
given drawn statistics, scale and
bias; for the stub, its own initialisation with drawn running statistics,
imported by the port's table with every live tensor consumed. Inputs:
seeded numpy images and the JAX package's synthetic clips.

Tolerance: 1e-4 px on the disparity (tests/torch_zoo_parity.DISP_TOL;
measured on the CPU: 2.2e-5 px against the JAX package, 3.7e-6 against
the stub, 2.0e-5 through the zoos; the faults 2.8e-2 px and more). The
fault of each test is the lookup read one pixel to the right. On the CPU
the lookup is kernel 6's plain version; tests/test_torch_zoo_kernels.py
holds the kernel to it on a card.
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu.models.raft_stereo import RAFTStereo as JRAFTStereo
from ppmstereo_tpu.models.raft_stereo import RAFTStereoConfig as JConfig
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu_torch.kernels import corr_lookup as kl
from ppmstereo_tpu_torch.models import raft_stereo as trs
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.utils.torch_import import import_by_mapping
from ppmstereo_tpu_torch.utils.weights import flatten_params, load_flax_params, state_dict_to_flax
from ppmstereo_tpu_torch.utils.zoo_mappings import is_zoo_dead_key, raftstereo_mapping
from tests.raftstereo_torch_stub import RAFTStereo as TorchRAFTStereo
from tests.test_torch_raft import draw_batch_norms
from tests.torch_zoo_parity import (
    DISP_TOL,
    carried,
    checked_port_init,
    jax_apply,
    max_diff,
    port_apply,
    stereo_clip,
)

torch.set_num_threads(1)


def _shift_lookup(monkeypatch):
    """The fault: every lookup read one pixel to the right."""
    monkeypatch.setattr(trs, "corr_lookup_kernel",
                        lambda pyr, x, radius, out_dtype: kl.corr_lookup_kernel(
                            pyr, x + 1.0, radius, out_dtype=out_dtype))


@pytest.fixture(scope="module")
def rs():
    """RAFT-Stereo's parameters (the port's initialisation, its variables
    checked against the JAX model's: tests/torch_zoo_parity.py::
    checked_port_init; drawn batch norms) and a 64x128 pair."""
    left, right, _ = stereo_clip(2, 64, 128, seed=2)
    i1, i2 = left[0, :1], right[0, :1]
    tree = draw_batch_norms(checked_port_init(JRAFTStereo(cfg=JConfig(), iters=4),
                                              trs.RAFTStereo(trs.RAFTStereoConfig(), 4), i1, i2),
                            seed=1)
    return tree, i1, i2


def test_raft_stereo_matches_jax(rs, monkeypatch):
    tree, i1, i2 = rs
    want = jax_apply(JRAFTStereo(cfg=JConfig(), iters=4), tree, i1, i2)
    model = carried(trs.RAFTStereo(trs.RAFTStereoConfig(), 4), tree)
    got = port_apply(model, i1, i2)
    assert got.shape == want.shape == (1, 64, 128, 1)
    assert np.isfinite(got).all()
    assert max_diff(got, want) <= DISP_TOL
    _shift_lookup(monkeypatch)
    assert max_diff(port_apply(model, i1, i2), want) > DISP_TOL


def test_raft_stereo_matches_torch_reference_through_mapping(monkeypatch):
    """The stub's state dict through the port's raftstereo_mapping (every
    live tensor consumed, every parameter of the port written), 4
    iterations at 64x128."""
    torch.manual_seed(0)
    ref = TorchRAFTStereo()
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.5)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) + 0.5)
    ref.eval()
    rng = np.random.default_rng(61)
    im1, im2 = (rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        _, want = ref(torch.from_numpy(im1).permute(0, 3, 1, 2),
                      torch.from_numpy(im2).permute(0, 3, 1, 2), iters=4)
    want = want.permute(0, 2, 3, 1).numpy()

    model = trs.RAFTStereo(trs.RAFTStereoConfig(), 4)
    template = {k.removeprefix("params/"): v
                for k, v in state_dict_to_flax(model.state_dict()).items()}
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    mapping = raftstereo_mapping()
    flat, missing = import_by_mapping(sd, template, mapping)
    unmapped = sorted(k for k in set(sd) - set(mapping) if not is_zoo_dead_key(k, mapping))
    assert not missing and not unmapped
    assert set(mapping.values()) == set(template)  # every port tensor written
    load_flax_params(model, flat)
    got = port_apply(model.eval(), im1, im2)
    assert got.shape == want.shape == (1, 64, 128, 1)
    assert max_diff(got, want) <= DISP_TOL
    _shift_lookup(monkeypatch)
    assert max_diff(port_apply(model, im1, im2), want) > DISP_TOL


def test_zoo_matches_jax_zoo(rs, monkeypatch):
    """A 6-frame clip through both zoos (window 4: three windows, each clip
    folded into the batch); no uncertainty in the output."""
    tree, _, _ = rs
    _, _, video = stereo_clip(6, 64, 128, seed=3)
    want = jmodel_zoo("RAFTStereoModel", kernel_size=4, iters=3, params=tree)(
        {"stereo_video": video})
    pred = tmodel_zoo("RAFTStereoModel", kernel_size=4, iters=3, params=flatten_params(tree),
                      device="cpu")
    got = pred({"stereo_video": video})
    assert sorted(got) == sorted(want) == ["disparity"]
    assert got["disparity"].shape == want["disparity"].shape == (6, 64, 128, 1)
    assert max_diff(got["disparity"], want["disparity"]) <= DISP_TOL
    _shift_lookup(monkeypatch)
    assert max_diff(pred({"stereo_video": video})["disparity"], want["disparity"]) > DISP_TOL


def test_adapter_folds_the_clip():
    """The adapter's parameters are RAFTStereo's (the JAX adapter's tree);
    each frame pair of a clip gives the disparity it gives alone."""
    adapter = trs.RAFTStereoVideoAdapter(trs.RAFTStereoConfig(), 2).eval()
    alone = trs.RAFTStereo(trs.RAFTStereoConfig(), 2).eval()
    alone.load_state_dict(adapter.state_dict())
    assert sorted(adapter.state_dict()) == sorted(alone.state_dict())
    left, right, _ = stereo_clip(2, 32, 64, seed=4)
    disp, unc = port_apply(adapter, left, right)
    assert disp.shape == unc.shape == (1, 2, 32, 64, 1) and not unc.any()
    for t in range(2):
        assert max_diff(disp[0, t], port_apply(alone, left[:, t], right[:, t])[0]) <= 1e-5


def test_carry_round_trip(rs):
    """FrozenBatchNorm's leaves carry as the rest: `scale` becomes the
    port's `weight`, `mean` and `var` (buffers) keep their names; written
    back in the flax layout, every leaf is the JAX tree's."""
    tree, _, _ = rs
    model = carried(trs.RAFTStereo(trs.RAFTStereoConfig(), 4), tree)
    assert {n for n, _ in model.cnet.norm1.named_buffers()} == {"mean", "var"}
    back = state_dict_to_flax(model.state_dict())
    flat = flatten_params(tree)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
