"""The train CLI data-parallel: `--data_parallel 2` on 2 ranks (the group
`parallel/launch.py::run_group` starts, which the CLI joins) for 2 steps of
PPMStereo at 64x128 in f32 on the synthetic fallback, against a
one-process `--batch_size 2` run.

* Only rank 0 writes: its checkpoint and its metrics log exist, and rank 1
  saved nothing.
* The logged losses equal the one-process run's within 1e-5 relative, and
  the checkpoint's tensors follow the update rule of
  tests/torch_train_parity.py: Adam's first updates are +-lr wherever a
  gradient is not tiny, so an element whose ~0 gradient (rounding noise,
  e.g. a bias ahead of an instance norm) has the other sign in the two runs
  moves by lr one way and the other. Every element within 2.01 times the
  two steps' rates of the one-process run's, and at most 1e-2 of them off
  by more than the first rate / 2. Read on the CPU: losses 7e-8 apart; at
  most 4.3e-4 (the bound 6.3e-4), 9.9e-4 of the elements off by more
  than 6e-6. (The norm of the difference over the norm of all tensors read
  2.2e-5: those flips.)
* A resume on 2 ranks continues from it: one more step, the same tensors
  on both ranks.
"""

import json

import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.cli import train as tcli
from ppmstereo_tpu_torch.parallel.launch import run_group
from ppmstereo_tpu_torch.parallel.mesh import backend_for
from ppmstereo_tpu_torch.train.state import onecycle_lr
from tests import torch_data_workers as workers

torch.set_num_threads(2)
REL_TOL = 1e-5
UPDATE_SHARE = 1e-2  # tests/torch_train_parity.py's


def _args(path, steps: int, extra=()):
    return ["--device", "cpu", "--image_size", "64", "128", "--sample_len", "2",
            "--train_iters", "1", "--num_workers", "1", "--no_mixed_precision",
            "--batch_size", "2", "--num_steps", str(steps), "--ckpt_path", str(path),
            "log_freq=1", *extra]


def _check_updates(got: dict, want: dict, steps: int) -> None:
    """The update rule above, for `steps` steps of the CLI's schedule."""
    lrs = [onecycle_lr(i, steps) for i in range(steps)]
    d = np.concatenate([np.abs(got[k].astype(np.float64) - want[k]).reshape(-1) for k in want])
    assert d.max() <= 2.01 * sum(lrs), (d.max(), lrs)
    assert (d > lrs[0] / 2).mean() <= UPDATE_SHARE


def _losses(path):
    return [json.loads(x)["loss"] for x in (path / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_data_parallel_and_resume(tmp_path):
    one = tmp_path / "one"
    workers.tensorboard_without_tensorflow()
    state = tcli.main(_args(one, 2))
    assert state.step == 2
    want = torch.load(one / "ckpt" / "step_2.pt", weights_only=True)["model"]
    want = {k: v.numpy() for k, v in want.items()}

    dp = tmp_path / "dp"
    ranks = run_group(workers.train_cli, 2, (_args(dp, 2, ("--data_parallel", "2")),),
                      timeout_s=300, threads=2)
    (step0, count0, saves0, params0), (step1, count1, saves1, params1) = ranks
    assert step0 == step1 == 2 and count0 == count1 == 2
    assert len(saves0) == 1 and saves1 == []  # the final save, rank 0's only
    ckpt = torch.load(dp / "ckpt" / "step_2.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["optimizer"]["count"] == 2
    got = {k: v.numpy() for k, v in ckpt["model"].items()}
    assert set(got) == set(want)
    _check_updates(got, want, 2)
    for k, v in got.items():
        np.testing.assert_array_equal(params0[k], v, err_msg=k)
        np.testing.assert_array_equal(params1[k], v, err_msg=k)
    losses = _losses(dp)
    assert len(losses) == 2  # rank 0's records alone
    np.testing.assert_allclose(losses, _losses(one), rtol=REL_TOL)

    ranks = run_group(workers.train_cli, 2, (_args(dp, 3, ("--data_parallel", "2")),),
                      timeout_s=300, threads=2)
    for step, count, _, params in ranks:
        assert step == 3 and count == 3
        for k, v in params.items():
            np.testing.assert_array_equal(ranks[0][3][k], v, err_msg=k)
    assert sorted(p.name for p in (dp / "ckpt").iterdir()) == ["step_2.pt", "step_3.pt"]
    assert len(_losses(dp)) == 3
    for path in (one, dp):  # ~780 MB a checkpoint: pytest keeps its last runs' directories
        for f in (path / "ckpt").iterdir():
            f.unlink()


def test_train_cli_refuses_a_data_axis_it_has_no_group_for():
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        tcli.main(_args("/nonexistent", 1, ("--data_parallel", "2")))


def test_backend_rule(monkeypatch):
    """NCCL when every rank of the host has a card of its own, gloo when
    ranks share one or run on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    assert backend_for(cuda, 2) == backend_for(cuda, 1) == "nccl"
    assert backend_for(cuda, 4) == "gloo"
    assert backend_for(torch.device("cpu"), 1) == "gloo"
