"""The port's RAFT (BiDAStereo's frozen flow provider) against the JAX
package's, and against a torch RAFT with the reference's state-dict layout
(tests/raft_torch_stub.py) brought in through the port's `raft_mapping`.

Weights: the JAX modules' `jax.jit(init)` parameters carried across with
`utils/weights.py`, every FrozenBatchNorm given drawn statistics, scale and
bias (at init they are the identity); for the stub, its own initialisation
with drawn running statistics, imported by the port's table with every live
tensor consumed. Inputs: seeded numpy images in [0, 255].

Tolerance: 1e-4 px on the flows (tests/torch_zoo_parity.DISP_TOL; measured
on the CPU: 4.8e-6 px against the JAX package, 5.7e-6 against the stub,
whose grid_sample works in normalised coordinates), 1e-4 on block outputs of order
1, 1e-5 relative on the correlation. Each test has a fault reading above its
limit.
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import raft as jraft
from ppmstereo_tpu.nn import gru as jgru
from ppmstereo_tpu_torch.models import raft as traft
from ppmstereo_tpu_torch.nn import gru as tgru
from ppmstereo_tpu_torch.ops.geometry import interp_ac_false
from ppmstereo_tpu_torch.utils.torch_import import import_by_mapping
from ppmstereo_tpu_torch.utils.weights import load_flax_params, state_dict_to_flax
from ppmstereo_tpu_torch.utils.zoo_mappings import is_zoo_dead_key, raft_mapping
from tests.raft_torch_stub import RAFT as TorchRAFT
from tests.torch_zoo_parity import DISP_TOL, carried, jax_apply, jax_init, max_diff, port_apply

torch.set_num_threads(1)
BLOCK_TOL = 1e-4


def draw_batch_norms(tree: dict, seed: int = 0) -> dict:
    """Every FrozenBatchNorm's scale, bias, mean and var drawn in place."""
    rng = np.random.default_rng(seed)

    def visit(node):
        for val in node.values():
            if isinstance(val, dict) and set(val) == {"scale", "bias", "mean", "var"}:
                c = val["mean"].shape
                val["scale"] = (rng.random(c) + 0.5).astype(np.float32)
                val["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                val["mean"] = rng.normal(0, 0.5, c).astype(np.float32)
                val["var"] = (rng.random(c) + 0.5).astype(np.float32)
            elif isinstance(val, dict):
                visit(val)

    visit(tree)
    return tree


def _images(h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def raft():
    """The JAX RAFT's parameters (drawn batch norms) and a 64x96 pair."""
    i1, i2 = _images(64, 96, seed=0)
    tree = draw_batch_norms(jax_init(jraft.RAFT(cfg=jraft.RAFTConfig(), iters=3), i1, i2))
    return tree, i1, i2


@pytest.mark.parametrize("name", ["SepConvGRU", "ConvGRU", "SKSepConvGRU"])
def test_2d_grus_match_jax(name):
    rng = np.random.default_rng(3)
    h = np.tanh(rng.normal(size=(2, 8, 12, 128))).astype(np.float32)
    x = rng.normal(size=(2, 8, 12, 256)).astype(np.float32)
    jm = getattr(jgru, name)(hidden_dim=128)
    tree = jax_init(jm, h, x)
    want = jax_apply(jm, tree, h, x)
    model = carried(getattr(tgru, name)(128, 256), tree)
    assert max_diff(port_apply(model, h, x), want) <= BLOCK_TOL
    # the fault: the z and r gates swapped
    prefix = "_SKConv" if name == "SKSepConvGRU" else "Conv"
    z, r = getattr(model, f"{prefix}_0"), getattr(model, f"{prefix}_1")
    zs = {k: v.clone() for k, v in z.state_dict().items()}
    z.load_state_dict(r.state_dict())
    r.load_state_dict(zs)
    assert max_diff(port_apply(model, h, x), want) > BLOCK_TOL


def test_frozen_batch_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    jm = jraft.FrozenBatchNorm()
    tree = draw_batch_norms({"params": {"bn": jax_init(jm, x)["params"]}})
    tree = {"params": tree["params"]["bn"]}
    want = jax_apply(jm, tree, x)
    model = carried(traft.FrozenBatchNorm(16), tree)
    assert sorted(n for n, _ in model.named_parameters()) == ["bias", "weight"]
    assert sorted(n for n, _ in model.named_buffers()) == ["mean", "var"]
    assert max_diff(port_apply(model, x), want) <= 1e-6
    with torch.no_grad():  # a bf16 input gives f32, as the JAX module promotes it
        assert model(torch.from_numpy(x).bfloat16()).dtype == torch.float32
    model.mean.zero_()  # the fault: the mean not subtracted
    assert max_diff(port_apply(model, x), want) > 1e-6


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_raft_encoder_matches_jax(norm_fn):
    i1, _ = _images(64, 96, seed=5)
    jm = jraft.RAFTEncoder(256, norm_fn)
    tree = draw_batch_norms(jax_init(jm, i1 / 127.5 - 1))
    want = jax_apply(jm, tree, i1 / 127.5 - 1)
    model = carried(traft.RAFTEncoder(256, norm_fn), tree)
    got = port_apply(model, i1 / 127.5 - 1)
    assert got.shape == want.shape == (1, 8, 12, 256)
    assert max_diff(got, want) <= BLOCK_TOL
    model.norm1 = torch.nn.Identity()  # the fault: the stem's norm left out
    assert max_diff(port_apply(model, i1 / 127.5 - 1), want) > BLOCK_TOL


def test_corr_pyramid_and_lookup_2d_match_jax():
    """The 2-D pyramid of (1, 8, 12) maps (odd rows and columns dropped at
    the coarser levels) and the radius-4 lookup at coordinates inside,
    on the border of and outside the map."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    f1 = rng.normal(size=(1, 8, 12, 64)).astype(np.float32)
    f2 = rng.normal(size=(1, 8, 12, 64)).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(12.0), np.arange(8.0)), -1)[None]
    coords = (coords + rng.uniform(-6, 6, coords.shape)).astype(np.float32)
    jpyr = jraft.build_corr_pyramid_2d(jnp.asarray(f1), jnp.asarray(f2), 4)
    tpyr = traft.build_corr_pyramid_2d(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [tuple(p.shape) for p in tpyr] == [tuple(p.shape) for p in jpyr] == [
        (96, 8, 12, 1), (96, 4, 6, 1), (96, 2, 3, 1), (96, 1, 1, 1)]
    scale = float(np.abs(np.asarray(jpyr[0])).max())
    for got, want in zip(tpyr, jpyr):
        assert max_diff(got.numpy(), want) <= 1e-5 * scale
    want = np.asarray(jraft.corr_lookup_2d(jpyr, jnp.asarray(coords), 4))
    got = traft.corr_lookup_2d(tpyr, torch.from_numpy(coords), 4).numpy()
    assert got.shape == want.shape == (1, 8, 12, 4 * 81)
    assert max_diff(got, want) <= 1e-5 * scale
    # the fault: the taps in x-inner order
    swapped = got.reshape(1, 8, 12, 4, 9, 9).swapaxes(-1, -2).reshape(got.shape)
    assert max_diff(swapped, want) > 1e-5 * scale


def test_raft_matches_jax(raft, monkeypatch):
    tree, i1, i2 = raft
    low_want, up_want = jax_apply(jraft.RAFT(cfg=jraft.RAFTConfig(), iters=3), tree, i1, i2)
    model = carried(traft.RAFT(traft.RAFTConfig(), 3), tree)
    low, up = port_apply(model, i1, i2)
    assert low.shape == low_want.shape == (1, 8, 12, 2)
    assert up.shape == up_want.shape == (1, 64, 96, 2)
    assert max_diff(low, low_want) <= DISP_TOL and max_diff(up, up_want) <= DISP_TOL
    lookup = traft.corr_lookup_2d
    monkeypatch.setattr(traft, "corr_lookup_2d",
                        lambda pyr, coords, r: lookup(pyr, coords + 1.0, r))
    assert max_diff(port_apply(model, i1, i2)[1], up_want) > DISP_TOL


def test_flow_provider_matches_jax(raft, monkeypatch):
    """0.25 x the 1/4 resize of the full-resolution flow."""
    tree, i1, i2 = raft
    want = jax_apply(jraft.RAFTFlowProvider(cfg=jraft.RAFTConfig(), iters=3),
                     {"params": {"raft": tree["params"]}}, i1, i2)
    model = traft.RAFTFlowProvider(traft.RAFTConfig(), 3)
    carried(model.raft, tree)
    got = port_apply(model.eval(), i1, i2)
    assert got.shape == want.shape == (1, 16, 24, 2)
    assert max_diff(got, want) <= DISP_TOL
    # the fault: the resize without align-corners
    monkeypatch.setattr(traft, "interp_bilinear", interp_ac_false)
    assert max_diff(port_apply(model, i1, i2), want) > DISP_TOL


def test_raft_matches_torch_reference_through_mapping():
    """The stub's state dict through the port's raft_mapping (every live
    tensor consumed, every parameter of the port written) into the port's
    RAFT, 4 iterations at 128x192 (the stub's grid_sample needs H/64 >= 2)."""
    torch.manual_seed(0)
    ref = TorchRAFT()
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.5)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) + 0.5)
    ref.eval()
    im1, im2 = _images(128, 192, seed=31)
    with torch.no_grad():
        _, want = ref(torch.from_numpy(im1).permute(0, 3, 1, 2),
                      torch.from_numpy(im2).permute(0, 3, 1, 2), iters=4)
    want = want.permute(0, 2, 3, 1).numpy()

    model = traft.RAFT(traft.RAFTConfig(), 4)
    template = {k.removeprefix("params/"): v
                for k, v in state_dict_to_flax(model.state_dict()).items()}
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    mapping = raft_mapping()
    flat, missing = import_by_mapping(sd, template, mapping)
    unmapped = sorted(k for k in set(sd) - set(mapping) if not is_zoo_dead_key(k, mapping))
    assert not missing and not unmapped
    assert set(mapping.values()) == set(template)  # every port tensor written
    load_flax_params(model, flat)
    _, got = port_apply(model.eval(), im1, im2)
    assert got.shape == want.shape == (1, 128, 192, 2)
    assert max_diff(got, want) <= DISP_TOL
    # the fault: the context encoder's running statistics left at init
    model.cnet.norm1.mean.zero_()
    model.cnet.norm1.var.fill_(1.0)
    assert max_diff(port_apply(model, im1, im2)[1], want) > DISP_TOL
