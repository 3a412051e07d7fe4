"""The mesh's seq axis of the port's PPMStereo inference: one window's
frames spread over processes, against the JAX package's unsharded
predictor and the port's own unsharded paths.

The case of tests/test_sharded_inference.py: the anchor (f32, iters 2),
kernel_size 4 on an 8-frame 64x128 video (windows of 4 frames at 0, 2 and
4 and a tail of 2 at 6), here with the shipped configuration, whose
temporal layers carry the anchor's trained taps (a seeded `TimeAttnBlock`
has a zero output projection, so only trained weights show a missing
halo). The processes form gloo groups (`parallel/launch.py::run_group`;
the bodies are in tests/torch_seq_workers.py).

* Units, port against port at 1e-6: each frame-mixing module sharded over
  seq 2 against itself unsharded (SKSepConvGRU3D, FlowHead,
  convex_upsample_3d, TimeAttnBlock, SSTBlock), on seeded inputs; the GRU
  runs in f64, because its f32 time convolutions over a block of another
  extent sum in another order (1.8e-6 apart at std-1 inputs), and the rest
  read 0 in f32.
* Whole paths against the JAX package's `SlidingWindowPredictor` without a
  mesh, within 1e-4 px, with equal picks: the strict seq-2 predictor and
  the whole-clip path (2 frames). The JAX package's own tests hold its
  sharded predictor to the same reference at that tolerance.
* The other window modes (warm_start, encoder_cache, batch_windows=2) under
  seq 2, on the video's first 6 frames (windows at 0 and 2 and a tail of
  2), against the port's unsharded predictor in the same mode, within the
  whole paths' 1e-4 px: the sharded convolutions sum over blocks of
  another extent, in another order, and three stages of iterations grow
  that to 2.1e-5 to 7.1e-5 px (up to 2.6e-6 relative, on disparities of
  ~25 px) with the processes' thread count and the clip, so 1e-5 px does
  not hold. tests/test_torch_inference_modes.py holds each mode to the JAX
  package.
* seq x space = 2 x 2 against the JAX predictor at the ring test's limit
  (1e-4 relative and absolute); data x seq = 2 x 2 on those 6 frames
  cropped to 32 x 64, the zoo's batch_windows=2 predictor against the
  unsharded one and the
  ParallelWindowPredictor against itself with the seq axis left out of its
  model (1e-4).
* The evaluate CLI with MODEL.mesh=1x2x1 on 2 ranks against its
  one-process run.
* The two faults of chip_smoke.py's phase seq, halos read as zeros and an
  ungathered bank, must leave the 1e-4 px limit.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu_torch.cli import evaluate as tcli
from ppmstereo_tpu_torch.parallel.launch import run_group
from tests import torch_seq_workers as workers
from tests.test_torch_evaluation import _dr_tree
from tests.torch_parity_data import load_anchor

torch.set_num_threads(2)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
UNIT_TOL = 1e-6
JAX_TOL = 1e-4  # px, tests/test_sharded_inference.py's

RING_TOL = 1e-4  # relative and absolute, as tests/test_torch_ring_attention.py holds the ring
K = workers.K
OUTPUTS = ("disparity", "uncertainties")


@pytest.fixture(scope="module")
def video():
    rng = np.random.default_rng(7)  # tests/test_sharded_inference.py's video
    return rng.uniform(0, 255, (8, 2, 64, 128, 3)).astype(np.float32)


def _jax_ref(video):
    """The JAX predictor without a mesh on the video and on its first 2
    frames (the whole-clip path), with every top-k pick recorded; its jitted
    windows (4 and 2 frames) serve both."""
    _, tree = load_anchor()
    picks: list = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda idx: picks.append(np.asarray(idx)), out[1], ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording_top_k)
        pred = jmodel_zoo("PPMStereoModel", kernel_size=K, iters=workers.ITERS, params=tree,
                          mixed_precision=False, force_xla_attention=True)
        ref = {}
        for name, clip in (("strict", video), ("whole", video[:2])):
            ref[name] = {k: np.asarray(v) for k, v in pred({"stereo_video": clip}).items()}
            jax.effects_barrier()
            ref[f"{name}_picks"] = list(picks)
            picks.clear()
    return ref


@pytest.fixture(scope="module")
def runs(video, tmp_path_factory):
    """Every reading of the file, computed once: the seq-2 group's and the
    4-process group's (both groups run while JAX compiles its reference),
    the JAX predictor's, and the evaluate CLI's one-process run on the
    fixture tree that the seq-2 group's CLI reads."""
    tmp = tmp_path_factory.mktemp("seq_cli")
    root = tmp / "datasets"
    _dr_tree(root / "dynamic_replica_data")
    args = [f"dataset_root={root}", "sample_len=4", "only_first_n_samples=1",
            f"MODEL.kernel_size={K}", "MODEL.iters=1", f"MODEL.checkpoint={ANCHOR}",
            "MODEL.model_kwargs=mixed_precision=False"]
    with ThreadPoolExecutor(2) as pool:
        seq2 = pool.submit(run_group, workers.seq_paths, 2,
                           (str(ANCHOR), video, {"args": args, "exp_root": str(tmp / "mesh")}),
                           timeout_s=600, threads=1)
        four = pool.submit(run_group, workers.four_ranks, 4, (str(ANCHOR), video),
                           timeout_s=600, threads=1)
        jax_ref = _jax_ref(video)
        one = tcli.main(["--device", "cpu", *args, f"exp_dir={tmp / 'one'}"])
        return dict(seq2=seq2.result(), four=four.result(), jax=jax_ref, cli=one, tmp=tmp)


@pytest.fixture(scope="module")
def seq2(runs):
    return runs["seq2"], runs["cli"], runs["tmp"]


@pytest.fixture(scope="module")
def four(runs):
    return runs["four"]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs["jax"]


@pytest.mark.parametrize("unit", ["SKSepConvGRU3D", "FlowHead", "convex_upsample_3d",
                                  "TimeAttnBlock", "SSTBlock"])
def test_unit_sharded_matches_unsharded(seq2, unit):
    """4 frames over seq 2 (2 a rank; the GRU's time pass takes a halo of
    2, the 3x3x3 convolutions and the upsample one)."""
    ranks, _, _ = seq2
    for r in ranks:
        assert r["units"][unit] <= UNIT_TOL, r["units"]


@pytest.mark.parametrize("path", ["strict", "whole"])
def test_seq_predictor_matches_jax(seq2, jax_ref, path):
    """The strict predictor (every window sharded: 2 + 2 frames, the tail
    1 + 1, whose GRU halo of 2 comes from the gathered window) and the
    whole-clip path (2 frames, 1 + 1) against the JAX predictor, with the
    JAX model's picks, window by window, stage by stage."""
    ranks, _, _ = seq2
    want = jax_ref[path]
    for r in ranks:
        got = r[path]
        for name in OUTPUTS:
            assert got[name].shape == want[name].shape
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=JAX_TOL,
                                       err_msg=f"{path} {name}")
        picks, jpicks = r[f"{path}_picks"], jax_ref[f"{path}_picks"]
        assert len(picks) == len(jpicks) == (4 if path == "whole" else 16)
        for p, jp in zip(picks, jpicks):
            np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(ranks[0][path]["disparity"], ranks[1][path]["disparity"])


@pytest.mark.parametrize("mode", ["warm_start", "encoder_cache", "batch_windows"])
def test_seq_window_modes_match_unsharded(seq2, mode):
    ranks, _, _ = seq2
    want = ranks[0 if mode != "batch_windows" else 1][f"unsharded_{mode}"]
    for r in ranks:
        for name in OUTPUTS:
            np.testing.assert_allclose(r[mode][name], want[name], rtol=0, atol=JAX_TOL,
                                       err_msg=f"{mode} {name}")


@pytest.mark.parametrize("fault", list(workers.FAULTS))
def test_faults_leave_the_limit(seq2, jax_ref, fault):
    """The first window (frames 0-3) with each fault against the JAX
    predictor's frames 0-2, which come from that window (the trim keeps 3)."""
    ranks, _, _ = seq2
    want = jax_ref["strict"]["disparity"][:3]
    for r in ranks:
        assert np.abs(np.abs(r[fault][0, :3]) - want).max() > JAX_TOL


def test_evaluate_cli_over_seq_matches_one_process(seq2):
    ranks, one, tmp = seq2
    assert (tmp / "mesh" / "rank0" / "result_dynamicreplica_final.json").is_file()
    assert not (tmp / "mesh" / "rank1").exists()
    for r in ranks:
        got = r["cli"]["aggregate"]
        assert got["num_sequences"] == one["aggregate"]["num_sequences"] == 1
        for k, v in one["aggregate"].items():
            if k != "fps":
                assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k


def test_seq_space_matches_jax(four, jax_ref):
    """seq x space = 2 x 2: each seq rank's frames ring their play steps
    over its space pair; every play of the 4 windows rings (rows 4, 8 and
    16 divide 2), 2 hops each."""
    want = jax_ref["strict"]
    for r in four:
        assert r["messages"] == 4 * 4 * 2
        for name in OUTPUTS:
            np.testing.assert_allclose(r["seq_space"][name], want[name], rtol=RING_TOL,
                                       atol=RING_TOL, err_msg=name)


def test_data_seq_matches_unsharded(four, seq2):
    """data x seq = 2 x 2: the zoo's batch_windows=2 predictor (each data
    rank one window of a pair, its frames over its seq pair) against the
    unsharded one; the ParallelWindowPredictor against its twin without
    the seq axis."""
    ranks, _, _ = seq2
    want = ranks[1]["unsharded_crop"]
    for r in four:
        for name in OUTPUTS:
            np.testing.assert_allclose(r["data_seq"][name], want[name], rtol=0, atol=RING_TOL,
                                       err_msg=f"batch_windows {name}")
            np.testing.assert_allclose(r["parallel"][name], r["parallel_no_seq"][name],
                                       rtol=0, atol=RING_TOL, err_msg=f"parallel {name}")
        assert r["parallel"]["disparity"].shape == (workers.MODE_FRAMES, workers.CROP_H,
                                                    workers.CROP_W, 1)
