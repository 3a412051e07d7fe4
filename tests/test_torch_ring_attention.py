"""The port's ring play attention against the JAX package's, and the
space-sharded model forward against the unsharded one.

  * the plain carry hop (`play_attention_carry_plain`, what the CPU runs
    at every hop) against the JAX carry kernel `flash_attend_carry` in
    Pallas interpret mode, two hops over a split K/V, f32 (2e-5: f32 sums
    in another order; P is rounded to the f32 value dtype, i.e. not at all);
  * `ring_play_attention` over gloo, in 2 and 4 spawned processes, against
    the JAX `ring_play_attention` on the 8-device CPU mesh of conftest.py,
    at the two shapes and meshes of tests/test_ring_attention.py (2e-5);
  * the model: the port's f32 PPMStereo test mode from the anchor weights
    in 2 and 4 processes against its own unsharded forward, at the JAX
    test's 1e-4. q/k/v are bf16 in the play step, and the ring rounds the
    unnormalised probabilities of each hop to bf16 where the unsharded play
    rounds the normalised ones: ~2^-8 of a probability in places (the JAX
    ring does the same). Read on the CPU: 8.6e-5 px at 64x128 in 2
    processes, 3.8e-5 px at 96x96 in 4.

The processes form their group through a FileStore in a temporary
directory (`parallel/launch.py::run_group`); no port is fixed.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ppmstereo_tpu.kernels.play_attention import _LANES, flash_attend_carry
from ppmstereo_tpu.parallel import mesh as jmesh
from ppmstereo_tpu.parallel.ring_attention import ring_play_attention as jring
from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.models.zoo import model_zoo
from ppmstereo_tpu_torch.parallel.launch import run_group
from ppmstereo_tpu_torch.parallel.mesh import Mesh, MeshSpec
from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz
from tests import torch_ring_workers as workers

torch.set_num_threads(1)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"


@pytest.mark.parametrize("lk", [512, 500])
def test_carry_plain_matches_flash_carry_interpret(lk):
    """Two hops over K/V split in halves (500: ragged halves of 250, which
    the JAX kernel pads to its 128-key blocks and masks), state by state."""
    rng = np.random.default_rng(4)
    b, lq, d = 2, 256, 128
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for n in (lq, lk, lk))
    scale = 0.13
    jo = jnp.zeros((b, lq, d), jnp.float32)
    jm = jnp.full((b, lq, _LANES), -1e30, jnp.float32)
    jl = jnp.zeros((b, lq, _LANES), jnp.float32)
    to = torch.zeros(b, lq, d)
    tm = torch.full((b, lq), -1e30)
    tl = torch.zeros(b, lq)
    half = lk // 2
    for sl in (slice(0, half), slice(half, lk)):
        jo, jm, jl = flash_attend_carry(jnp.asarray(q), jnp.asarray(k[:, sl]),
                                        jnp.asarray(v[:, sl]), jo, jm, jl, scale,
                                        block_q=128, block_k=128, interpret=True)
        to, tm, tl = tpa.play_attention_carry(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k[:, sl], v[:, sl])),
            to, tm, tl, scale)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm)[..., 0], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[..., 0], rtol=2e-5, atol=2e-5)


def _jax_ring(q, k, v, scale, spec):
    mesh = jmesh.make_mesh(jmesh.MeshSpec(*spec))
    seq = "seq" if spec[1] > 1 else None
    sh_q = NamedSharding(mesh, P(None, seq, "space", None, None))
    sh_kv = NamedSharding(mesh, P(None, seq, None, "space", None, None))
    with mesh:
        out = jax.jit(lambda a, b_, c_: jring(a, b_, c_, scale, mesh))(
            jax.device_put(jnp.asarray(q), sh_q), jax.device_put(jnp.asarray(k), sh_kv),
            jax.device_put(jnp.asarray(v), sh_kv))
    return np.asarray(out)


@pytest.mark.parametrize("spec,shape,scale,seed", [
    ((1, 2, 2), (1, 4, 3, 16, 8), 0.11, 0),  # tests/test_ring_attention.py:36, 4 processes
    ((1, 1, 4), (1, 3, 2, 8, 4), 0.2, 1),    # :61, 4 processes
    ((1, 1, 2), (1, 3, 2, 8, 4), 0.2, 1),    # the same at space 2, 2 processes
])
def test_ring_matches_jax_ring(spec, shape, scale, seed):
    """Each process holds its (seq, space) block; the seq 2 x space 2 mesh
    runs two independent rings, one per seq position."""
    rng = np.random.default_rng(seed)
    b, r, kf, h, w = shape
    q = rng.standard_normal((b, r, h, w, 128)).astype(np.float32)
    k = rng.standard_normal((b, r, kf, h, w, 128)).astype(np.float32)
    v = rng.standard_normal((b, r, kf, h, w, 128)).astype(np.float32)
    want = _jax_ring(q, k, v, scale, spec)
    blocks = dict(run_group(workers.ring_block, MeshSpec(*spec).size,
                            (spec, q, k, v, scale), timeout_s=120))
    n_seq, n_space = spec[1], spec[2]
    got = np.concatenate([np.concatenate([blocks[(s, p)] for p in range(n_space)], axis=2)
                          for s in range(n_seq)], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def anchor():
    return load_npz(ANCHOR)


@pytest.mark.parametrize("h,w,world,ring_plays", [
    (64, 128, 2, 4),  # every stage's rows (4, 8, 16) divide 2: all 4 plays ring
    (96, 96, 4, 3),   # the 1/16 stage's 6 rows do not divide 4: unsharded there
])
def test_model_ring_matches_unsharded(anchor, h, w, world, ring_plays):
    """4 frames, 2 iterations (1 + 1 + 2 plays over the three stages)."""
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (1, 4, h, w, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, 4, h, w, 3)).astype(np.float32)
    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=2, test_mode=True)
    load_flax_params(model, anchor)
    with torch.no_grad():
        disp, unc = (x.numpy() for x in model(torch.from_numpy(left), torch.from_numpy(right)))
    results = run_group(workers.model_forward, world, (str(ANCHOR), left, right, 2),
                        timeout_s=240)
    for rank_disp, rank_unc, messages in results:
        assert messages == ring_plays * world  # n hops, one message each
        np.testing.assert_array_equal(rank_disp, results[0][0])
        np.testing.assert_allclose(rank_disp, disp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rank_unc, unc, rtol=1e-4, atol=1e-4)


def test_model_ring_matches_unsharded_without_cnet(anchor):
    """Without the context net (`use_cnet=False`, as the JAX package's
    multi-device tests build the model) the input needs no height of a
    multiple of 32: at 80 x 96 the stages have 20, 10 and 5 rows, so over 2
    processes the 1/16 stage's play runs unsharded and the 1/8 and 1/4
    stages' 3 plays ring."""
    rng = np.random.default_rng(4)
    left = rng.uniform(0, 255, (1, 4, 80, 96, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, 4, 80, 96, 3)).astype(np.float32)
    cfg_kwargs = {"use_cnet": False}
    model = PPMStereo(PPMStereoConfig(mixed_precision=False, **cfg_kwargs), iters=2,
                      test_mode=True)
    load_flax_params(model, workers.anchor_params_of(model, anchor))
    with torch.no_grad():
        disp, unc = (x.numpy() for x in model(torch.from_numpy(left), torch.from_numpy(right)))
    results = run_group(workers.model_forward, 2, (str(ANCHOR), left, right, 2, cfg_kwargs),
                        timeout_s=240)
    for rank_disp, rank_unc, messages in results:
        assert messages == 3 * 2
        np.testing.assert_array_equal(rank_disp, results[0][0])
        np.testing.assert_allclose(rank_disp, disp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rank_unc, unc, rtol=1e-4, atol=1e-4)


def test_mesh_layout_and_size_check():
    """Ranks are row-major over (data, seq, space); the space neighbours of
    a rank are consecutive ranks. A group of the wrong size raises."""
    layout = run_group(workers.mesh_coords, 4, ((1, 2, 2),), timeout_s=60)
    for rank, (coords, groups) in enumerate(layout):
        assert coords == {"data": 0, "seq": rank // 2, "space": rank % 2}
        assert groups["data"] is None
        assert groups["space"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert groups["seq"] == [rank % 2, rank % 2 + 2]
    errors = run_group(workers.make_mesh_fails, 2, ((1, 2, 2),), timeout_s=60)
    assert all("needs 4 processes" in e for e in errors)


def test_space_mesh_is_for_inference_and_other_axes_wait():
    """No process group is needed to refuse a mesh. The data axis is live
    (tests/test_torch_data_*.py): its batch-mean group reaches every stage.
    The seq axis is live in inference (tests/test_torch_seq_inference.py)
    and in training (tests/test_torch_seq_train.py); for PPMStereo-VDA and
    the rest of the zoo it waits for ROADMAP §1 item 7.1b. The space axis in
    training waits for item 7.3's space half, after item 7.2."""
    coords = {"data": 0, "seq": 0, "space": 0}
    space = Mesh(MeshSpec(space=2), coords, {"data": None, "seq": None, "space": object()})
    with pytest.raises(NotImplementedError, match=r"item 7\.3's space half, after item 7\.2"):
        PPMStereo(iters=2, test_mode=False, mesh=space)
    seq_group = object()
    seq = Mesh(MeshSpec(seq=2), coords, {"data": None, "seq": seq_group, "space": None})
    for test_mode in (True, False):
        assert PPMStereo(iters=2, test_mode=test_mode, mesh=seq).seq_group is seq_group
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.1b"):
        PPMStereo(PPMStereoConfig(use_vfm=True), iters=2, test_mode=True, mesh=seq)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.1b"):
        model_zoo("DynamicStereoModel", iters=1, device="cpu", mesh=seq)
    group = object()
    data = Mesh(MeshSpec(data=2), coords, {"data": object(), "seq": None, "space": None}, group)
    for test_mode in (True, False):
        model = PPMStereo(iters=2, test_mode=test_mode, mesh=data)
        assert all(getattr(model, f"update_block{s}").data_group is group
                   for s in ("16", "08", "04"))
    assert PPMStereo(iters=2, test_mode=True, mesh=Mesh(MeshSpec(), coords, {
        "data": None, "seq": None, "space": None})).update_block04.space_group is None
