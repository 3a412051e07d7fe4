"""The mesh's seq axis in the port's training: a training clip's frames
spread over processes, against the JAX package's step on the whole batch
(what XLA computes under P("data", "seq", "space")) and the port's own
one-process step.

* The backward of the two seq messages, `gather_frames` and `time_halo`
  (halos of 1 and 2 frames, a block thinner than its halo, the clip's two
  ends; over seq 2, and over seq 4 with two middle ranks), in f64: each
  rank's loss <W_r, op(x_r)> with a cotangent of its own, and each rank's
  gradient against (a) the same ops on the unsharded tensor under autograd
  within UNIT_TOL and (b) central differences of the ranks' summed loss
  within FD_TOL (read up to 5.0e-9: the differences' rounding).
* One seq-2 train step of the tiny PPMStereo of tests/test_torch_train.py
  (the anchor, f32, iters 2, 4 frames; each rank 2 frames) against the JAX
  trainer's step on the same batch, at 32x64: at 64x128 the JAX step's
  run alone takes 60 s on an 8-core CPU host (194 s of CPU time; the GRU's
  convolutions dominate its ~67 GFLOP at 32x64), at 32x64 5.8 s, and this
  file runs inside the tier-1 suite's time limit. The
  check: the loss and the metrics, the gradients and the parameters after
  one AdamW update within tests/torch_train_parity.py's limits (the
  gradients read 6.1e-4, the encoders' 7.9e-6); the ranks' parameters
  bit-equal. Against the port's one-process step: the loss and every
  gradient within SEQ_REL_TOL (read 0 and 1.2e-6: the sharded convolutions
  sum over blocks of another extent).
* The planted faults, on the same step against the JAX step: the gather's
  backward keeping the rank's block of its own cotangent reads a gradient
  error of 2.67, and the halo's backward dropping the cotangents it should
  send back 2.57 (a GRU time-pass bias): both far beyond the 2.5e-3 limit.
* data x seq = 2 x 2 (4 processes; batch 2 of 4 frames, one clip and 2
  frames a rank) against the port's one-process step within SEQ_REL_TOL
  (read 1.7e-6).
* The refusals: a clip the seq axis does not divide (sample_len 5 over
  seq 2) raises in the port's trainer as in the JAX package's placement of
  the batch on its mesh; PPMStereo-VDA and the baselines under seq name
  ROADMAP §1 item 7.1b; space_parallel > 1 names item 7.3's space half,
  after item 7.2.
* The train CLI with --seq_parallel 2 for one step on 2 frames (one a
  rank: the GRU's halo of 2 through the gather), run in the seq-2 group.

The processes come from `parallel/launch.py::run_group` (gloo through a
FileStore, one torch thread each) and run while JAX compiles its step;
their bodies are in tests/torch_seq_workers.py.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from ppmstereo_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ppmstereo_tpu.parallel.mesh import make_mesh as jmake_mesh
from ppmstereo_tpu.parallel.sharding import shard_batch
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.parallel.launch import run_group
from ppmstereo_tpu_torch.parallel.mesh import Mesh, MeshSpec
from ppmstereo_tpu_torch.train import trainer as ttrainer
from tests import torch_seq_workers as workers
from tests import torch_train_parity as tp
from tests.torch_parity_data import load_anchor

ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
UNIT_TOL = 1e-6
FD_TOL = 1e-7
SEQ_REL_TOL = 1e-5  # against the port's one-process step
FRAMES, H, W = 4, 32, 64
CLI_FRAMES = 2


def _batch(clips: int, frames: int, h: int, w: int) -> dict:
    """`clips` clips of the JAX package's synthetic dataset, seeds 0, 1, ..."""
    parts = [tp.batch(frames, h, w, seed=s) for s in range(clips)]
    return {k: np.concatenate([p[k] for p in parts]).astype(np.float32) for k in parts[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every reading of the file, computed once: the seq-2 group's and the
    data x seq group's (both run while JAX compiles its step) and the JAX
    trainer's step on the seq-2 group's batch."""
    flat, tree = load_anchor()
    batch = _batch(1, FRAMES, H, W)
    pair = _batch(2, FRAMES, H, W)
    ckpt = tmp_path_factory.mktemp("seq_cli")
    cli_args = ["--device", "cpu", "--image_size", str(H), str(W), "--sample_len",
                str(CLI_FRAMES), "--train_iters", "1", "--num_steps", "1", "--num_workers", "1",
                "--no_mixed_precision", "--seq_parallel", "2", "--batch_size", "1",
                "--ckpt_path", str(ckpt), "log_freq=1"]
    with ThreadPoolExecutor(2) as pool:
        seq2 = pool.submit(run_group, workers.seq_train, 2, (str(ANCHOR), batch, cli_args),
                           timeout_s=600)
        four = pool.submit(run_group, workers.data_seq_train, 4, (str(ANCHOR), pair),
                           timeout_s=600)
        jax_run, jax_metrics = tp.jax_ppm_step(tree, batch)  # the anchor's 5-frame embedding
        out = dict(seq2=seq2.result(), four=four.result(), jax=jax_run,
                   jax_metrics=jax_metrics, flat=flat, ckpt=ckpt)
    log = (ckpt / "metrics.jsonl").read_text().splitlines()
    out["cli_log"] = log
    for saved in (ckpt / "ckpt").glob("*.pt"):  # ~780 MB
        saved.unlink()
    return out


@pytest.mark.parametrize("group", ["seq2", "seq4"])
@pytest.mark.parametrize("case", [c[0] for c in workers.COLLECTIVE_CASES])
def test_collective_backward(runs, group, case):
    ranks = runs["seq2"] if group == "seq2" else runs["four"]
    for r in ranks:
        unsharded, differences = r["units"][case]
        assert unsharded <= UNIT_TOL, (case, unsharded)
        assert differences <= FD_TOL, (case, differences)


def test_seq_step_matches_the_jax_step(runs, record_property):
    ranks = runs["seq2"]
    for rank, r in enumerate(ranks):
        metrics, grads, params = r["sound"]
        readings = tp.check_step(runs["jax"], (metrics["loss"], grads, params, None),
                                 runs["flat"])
        record_property(f"rank{rank}", readings)
        # the bad-pixel rates count FRAMES x H x W pixels: one pixel either
        # side of a threshold moves a rate by 100 / (FRAMES H W)
        assert metrics["epe"] == pytest.approx(runs["jax_metrics"]["epe"], rel=tp.LOSS_TOL)
        for k in ("1px", "3px", "5px"):
            assert abs(metrics[k] - runs["jax_metrics"][k]) <= 100 * 2 / (FRAMES * H * W), k
        # every message went, both ways
        assert all(v > 0 for v in r["received"].values()), r["received"]
    for k, v in ranks[0]["sound"][2].items():
        np.testing.assert_array_equal(ranks[1]["sound"][2][k], v, err_msg=k)


def _against_one_process(got, want) -> float:
    """The loss and every gradient of a sharded step against the
    one-process step's (relative), and its update by the update rule of
    tests/torch_train_parity.py; returns the gradient reading."""
    (metrics, grads, params), (want_metrics, want_grads, want_params) = got, want
    assert metrics["loss"] == pytest.approx(want_metrics["loss"], rel=SEQ_REL_TOL)
    assert set(grads) == set(want_grads)
    err = tp.grad_error(grads, want_grads)[0]
    assert err <= SEQ_REL_TOL, err
    worst, share = tp.update_error(params, want_params, want_grads)
    assert worst <= 2.01 and share <= tp.UPDATE_SHARE, (worst, share)
    return err


def test_seq_step_matches_one_process(runs, record_property):
    ranks = runs["seq2"]
    for rank, r in enumerate(ranks):
        record_property(f"rank{rank}", _against_one_process(r["sound"], ranks[1]["one"]))


def test_data_seq_step_matches_one_process(runs, record_property):
    ranks = runs["four"]
    for rank, r in enumerate(ranks):
        record_property(f"rank{rank}", _against_one_process(r["step"], ranks[3]["one"]))
    for r in ranks[1:]:
        for k, v in ranks[0]["step"][2].items():
            np.testing.assert_array_equal(r["step"][2][k], v, err_msg=k)


@pytest.mark.parametrize("fault", list(workers.TRAIN_FAULTS))
def test_backward_faults_leave_the_limits(runs, fault, record_property):
    for r in runs["seq2"]:
        metrics, grads, params = r[fault]
        with pytest.raises(AssertionError):
            tp.check_step(runs["jax"], (metrics["loss"], grads, params, None), runs["flat"])
        record_property("grad_error", tp.grad_error(grads, runs["jax"][1])[0])


def test_train_cli_over_seq(runs):
    """One step of the train CLI on 2 ranks: each rank's frames went over
    the axis, rank 0 alone saved and logged, the parameters bit-equal."""
    ranks = runs["seq2"]
    for rank, r in enumerate(ranks):
        cli = r["cli"]
        assert (cli["step"], cli["count"]) == (1, 1)
        assert cli["received"]["halo"] > 0 and cli["received"]["halo_grad"] > 0
        assert len(cli["saves"]) == (1 if rank == 0 else 0)
    for k, v in ranks[0]["cli"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["cli"]["params"][k], v, err_msg=k)
    assert len(runs["cli_log"]) == 1


def test_a_clip_the_seq_axis_does_not_divide_raises():
    """sample_len 5 over seq 2: the port's trainer refuses it before it
    starts, and the JAX package's placement of such a batch on a mesh with
    seq 2 raises."""
    with pytest.raises(ValueError, match="a clip of 5 frames does not divide over a seq axis"):
        ttrainer.train(ttrainer.TrainConfig(seq_parallel=2), device="cpu")
    mesh = jmake_mesh(JMeshSpec(data=2, seq=2))
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(mesh, {"left": np.zeros((2, 5, 8, 8, 3), np.float32)})
    shard_batch(mesh, {"left": np.zeros((2, 6, 8, 8, 3), np.float32)})


@pytest.mark.parametrize("name", ["ppmstereo_vda", "dynamicstereo", "bidastereo",
                                  "stereoanyvideo"])
def test_seq_training_of_the_other_models_waits(name):
    cfg = ttrainer.TrainConfig(model_name=name, seq_parallel=2, sample_len=6)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.1b"):
        ttrainer.train(cfg, device="cpu")


def test_space_training_waits():
    """space_parallel > 1 in the trainer, and a space mesh in PPMStereo's
    train mode (no process group is needed to refuse it); PPMStereo-VDA
    under seq in train mode too."""
    with pytest.raises(NotImplementedError, match=r"item 7\.3's space half, after item 7\.2"):
        ttrainer.train(ttrainer.TrainConfig(space_parallel=2), device="cpu")
    coords = {"data": 0, "seq": 0, "space": 0}
    space = Mesh(MeshSpec(seq=2, space=2), coords,
                 {"data": None, "seq": object(), "space": object()})
    with pytest.raises(NotImplementedError, match=r"item 7\.3's space half, after item 7\.2"):
        PPMStereo(iters=2, test_mode=False, mesh=space)
    seq = Mesh(MeshSpec(seq=2), coords, {"data": None, "seq": object(), "space": None})
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.1b"):
        PPMStereo(PPMStereoConfig(use_vfm=True), iters=2, test_mode=False, mesh=seq)
