"""The data axis of the port's inference and evaluation against the JAX
package's.

* `ParallelWindowPredictor` at data 2 (2 processes) against the JAX one on
  the 8-device CPU mesh of conftest.py, with
  tests/test_harness.py::TestParallelStreaming's window function and its
  (k, n) cases (4, 10) and (10, 23): the same stitched video (1e-5).
* The tiny PPMStereo (the anchor, f32, iters 2) through
  `model_zoo(..., batch_windows=2, mesh=data 2)`: its batched-window call
  on a stacked pair of 4-frame 64x128 windows, each rank running one,
  against the JAX model applied to the pair (B = 2), within 1e-4 px; and the
  whole 6-frame clip, whose first five frames come from that pair of
  windows. The picked frames' scores are normalised by their mean over the
  batch, so a rank that ran its window alone would part from the pair.
* The same pair under a data x space = 2 x 2 mesh (4 processes: each data
  rank's window rings its play steps over its space pair) against the JAX
  model on the pair, within the ring test's limit (1e-4 relative and
  absolute).
* A batch that the data axis does not divide raises, as the JAX predictor
  does on the 8 fake devices.
* `evaluate_distributed` over 2 ranks against the JAX one in one process,
  with one fake predictor (mean |left - right|) and 3 sequences of unequal
  length: the same `shard_sequences` and the same metrics (1e-6).
* The evaluate CLI with MODEL.mesh=2x1x1 and MODEL.batch_windows=2 on 2
  ranks on a Dynamic Replica fixture tree against its one-process run with
  the same batch_windows; only rank 0 writes its results.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.evaluation import distributed as jdist
from ppmstereo_tpu.models.inference import SlidingWindowPredictor as JSliding
from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JConfig
from ppmstereo_tpu.parallel import mesh as jmesh
from ppmstereo_tpu.parallel.streaming import ParallelWindowPredictor as JParallel
from ppmstereo_tpu_torch.cli import evaluate as tcli
from ppmstereo_tpu_torch.evaluation import distributed as tdist
from ppmstereo_tpu_torch.parallel.launch import run_group
from tests import torch_data_workers as workers
from tests.test_torch_evaluation import _dr_tree
from tests.torch_parity_data import load_anchor, synthetic_clip

torch.set_num_threads(2)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
WINDOW_CASES = ((4, 10), (10, 23))  # tests/test_harness.py::TestParallelStreaming
K, FRAMES, H, W = 4, 6, 64, 128
MODEL_TOL = 1e-4  # px
RING_TOL = 1e-4  # relative and absolute, as tests/test_torch_ring_attention.py holds the ring
METRIC_TOL = 1e-6


def _jax_window_fn(left, right):
    d = jnp.mean(jnp.abs(left - right), axis=-1, keepdims=True)
    return d, jnp.zeros_like(d)


def _sequences():
    """3 sequences of 3, 5 and 4 frames with ground truth."""
    rng = np.random.default_rng(5)
    out = []
    for t in (3, 5, 4):
        img = rng.uniform(0, 255, (t, 2, 16, 24, 3)).astype(np.float32)
        disp = -rng.uniform(0, 80, (t, 1, 16, 24, 1)).astype(np.float32)
        valid = (rng.random((t, 1, 16, 24)) > 0.1).astype(np.float32)
        out.append({"img": img, "disp": disp, "valid": valid})
    return out


def _eval_args(root):
    return [f"dataset_root={root}", "sample_len=4", "only_first_n_samples=2",
            "MODEL.kernel_size=2", "MODEL.iters=1", "MODEL.batch_windows=2",
            f"MODEL.checkpoint={ANCHOR}", "MODEL.model_kwargs=mixed_precision=False"]


@pytest.fixture(scope="module")
def anchor():
    return load_anchor()


@pytest.fixture(scope="module")
def clip():
    """The 6-frame clip and the stacked pair of its windows at 0 and 2
    (2, K, 2, H, W, 3)."""
    video, _ = synthetic_clip(FRAMES, H, W, seed=2)
    return video, np.stack([video[0:K], video[2:2 + K]])


@pytest.fixture(scope="module")
def jax_pair(anchor, clip):
    """The JAX model in test mode on the stacked pair (B = 2)."""
    _, tree = anchor
    _, pair = clip
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True), iters=2,
                    test_mode=True)
    disp, unc = jax.jit(jm.apply)(tree, jnp.asarray(pair[:, :, 0]), jnp.asarray(pair[:, :, 1]))
    return np.asarray(disp), np.asarray(unc)


def test_data_axis_paths_match_jax(clip, jax_pair, tmp_path):
    rng = np.random.default_rng(7)
    cases = [(k, rng.uniform(0, 255, (n, 2, 32, 32, 3)).astype(np.float32))
             for k, n in WINDOW_CASES]
    video, pair = clip
    sequences = _sequences()
    root = tmp_path / "datasets"
    _dr_tree(root / "dynamic_replica_data")
    eval_args = {"args": _eval_args(root), "exp_root": str(tmp_path / "mesh")}
    ranks = run_group(workers.data_axis_paths, 2,
                      (cases, str(ANCHOR), pair, video, sequences, eval_args),
                      timeout_s=400, threads=2)

    # the parallel window predictor against the JAX one on a data-2 mesh
    jmesh_2 = jmesh.make_mesh(jmesh.MeshSpec(data=2, seq=1, space=1))
    for (k, v), *got in zip(cases, *(r["windows"] for r in ranks)):
        want = JParallel(_jax_window_fn, jmesh_2, kernel_size=k)(v)
        assert np.asarray(want["disparity"]).shape == (len(v), 32, 32, 1)
        np.testing.assert_allclose(np.asarray(JSliding(_jax_window_fn, kernel_size=k)(v)[
            "disparity"]), want["disparity"], rtol=1e-5, atol=1e-6)
        for g in got:
            for name in ("disparity", "uncertainties"):
                np.testing.assert_allclose(g[name], np.asarray(want[name]), rtol=1e-5,
                                           atol=1e-6, err_msg=f"k={k} {name}")

    # the zoo's batched windows against the JAX model on the stacked pair
    jd, ju = jax_pair
    stride = K // 2
    for r in ranks:
        disp, unc = r["pair"]
        np.testing.assert_allclose(disp, jd, rtol=0, atol=MODEL_TOL)
        np.testing.assert_allclose(unc, ju, rtol=0, atol=MODEL_TOL)
        # frames 0-2 from the first window, 3-4 from the second (trims of 1)
        stitched = np.concatenate([jd[0, :K - 1], jd[1, 1:K - 1]])
        np.testing.assert_allclose(r["clip"][:2 * stride + 1], np.abs(stitched), rtol=0,
                                   atol=MODEL_TOL)
    np.testing.assert_array_equal(ranks[0]["clip"], ranks[1]["clip"])
    for r in ranks:  # 3 windows of one length over data 2 (the JAX refusal below)
        assert r["indivisible"] == "a batch of 3 does not divide over a data axis of 2"

    # evaluate_distributed against the JAX one in one process
    want = jdist.evaluate_distributed(None, workers.fake_predictor, sequences, jmesh_2)
    assert tdist.shard_sequences(3, 1, 2) == jdist.shard_sequences(3, 1, 2) == [1]
    assert tdist.shard_sequences(3, 0, 2) == jdist.shard_sequences(3, 0, 2) == [0, 2]
    for r in ranks:
        assert set(r["eval"]) == set(want)
        for k, v in want.items():
            assert r["eval"][k] == pytest.approx(v, rel=METRIC_TOL, abs=METRIC_TOL), k

    # the evaluate CLI on 2 ranks against its one-process run
    one = tcli.main(["--device", "cpu", *eval_args["args"], f"exp_dir={tmp_path / 'one'}"])
    assert (tmp_path / "mesh" / "rank0" / "result_dynamicreplica_final.json").is_file()
    assert not (tmp_path / "mesh" / "rank1").exists()
    for r in ranks:
        got = r["cli"]
        assert got["aggregate"]["num_sequences"] == one["aggregate"]["num_sequences"] == 2
        for k, v in one["aggregate"].items():
            if k != "fps":
                assert got["aggregate"][k] == pytest.approx(v, rel=1e-5, abs=1e-5), k


def test_pair_over_data_and_space_matches_jax(jax_pair, clip):
    _, pair = clip
    ranks = run_group(workers.pair_over_data_and_space, 4, (str(ANCHOR), pair),
                      timeout_s=300, threads=1)
    jd, ju = jax_pair
    for (disp, unc), messages in ranks:
        assert messages == 4 * 2  # every play of the window rings: 2 hops each
        # the ring test's limit (tests/test_torch_ring_attention.py): the ring
        # rounds each hop's unnormalised probabilities to bf16; read on the
        # CPU: 2.5e-4 px at most, on disparities of ~11 px
        np.testing.assert_allclose(disp, jd, rtol=RING_TOL, atol=RING_TOL)
        np.testing.assert_allclose(unc, ju, rtol=RING_TOL, atol=RING_TOL)


def test_a_batch_the_data_axis_does_not_divide_raises():
    """The JAX predictor on the fake devices refuses a batch of 3 windows
    over data 2 (its sharding does not divide); so does the port's
    (`data_axis_paths` reads the port's error on 2 ranks)."""
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 255, (8, 2, 32, 32, 3)).astype(np.float32)
    jpred = JSliding(_jax_window_fn, kernel_size=4, batch_windows=3,
                     mesh=jmesh.make_mesh(jmesh.MeshSpec(data=2, seq=1, space=1)))
    with pytest.raises(ValueError, match="divisible by 2"):
        jpred(video)
