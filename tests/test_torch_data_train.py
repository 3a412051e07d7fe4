"""The data axis of the port's training against the JAX package's step on
the global batch (what XLA computes under `MeshSpec(data=N)`).

* The batch split and the loader: each rank's block of a global batch, put
  back together in rank order, is the batch bit for bit (2 and 3 ranks);
  two ranks of the loader load, between them, one process's batches over
  two epochs.
* The loss over 2 processes with uneven valid counts (one clip almost all
  invalid): the ranks' shares add up to the JAX `sequence_loss` of the
  global batch within 1e-6 relative, every rank's metrics are the JAX
  metrics, and the mean of the ranks' own means misses that limit.
* One data-parallel train step of the tiny PPMStereo of
  tests/test_torch_train.py (the anchor, f32, iters 2, 3 frames at
  64x128), batch 2 over 2 processes, against the JAX trainer's step on the
  global batch: the loss and the metrics, the gradients and the parameters
  after one AdamW update within tests/torch_train_parity.py's limits (the
  same as tests/test_torch_train.py's); the ranks' parameters bit-equal.
  With the batch mean of the picked frames' scores taken over each rank's
  own clip (the fault) the same check fails: on the CPU the 1/4 stage's
  play blend `beta` reads 5.9e-3 against the 2.5e-3 gradient limit, where
  the sound step reads 8e-6 against the port's one-process step.
* DynamicStereo (no uncertainty head, no batch coupling) at data 2 against
  the port's one-process step on batch 2: the loss and the gradients within
  1e-5 relative (read 2.7e-6), the updated parameters by the update rule
  of tests/torch_train_parity.py (Adam's first update is +-lr wherever a
  gradient is not ~0, so a ~0 gradient of the other sign moves an element
  by 2 lr: the parameters' norm ratio read 5.1e-5).

The processes come from `parallel/launch.py::run_group` (gloo through a
FileStore), their bodies from tests/torch_data_workers.py.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.train.loss import sequence_loss as jsequence_loss
from ppmstereo_tpu_torch.data import datasets as tds
from ppmstereo_tpu_torch.data.loader import PrefetchLoader
from ppmstereo_tpu_torch.parallel.launch import run_group
from ppmstereo_tpu_torch.parallel.sharding import local_batch, local_slice
from tests import torch_data_workers as workers
from tests import torch_train_parity as tp
from tests.torch_parity_data import load_anchor

torch.set_num_threads(2)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
LOSS_SHARE_TOL = 1e-6
DS_REL_TOL = 1e-5


def _global_batch(n: int, frames: int, h: int, w: int) -> dict:
    """n clips of the JAX package's synthetic dataset, seeds 0 .. n-1."""
    clips = [tp.batch(frames, h, w, seed=s) for s in range(n)]
    return {k: np.concatenate([c[k] for c in clips]).astype(np.float32) for k in clips[0]}


# ------------------------------------------------- the split and the loader
@pytest.mark.parametrize("ranks", [2, 3])
def test_rank_blocks_put_back_together_are_the_batch(ranks):
    rng = np.random.default_rng(ranks)
    batch = {"left": rng.standard_normal((6, 2, 4, 5, 3)).astype(np.float32),
             "valid": rng.random((6, 2, 4, 5)) > 0.5}
    blocks = [local_batch(batch, r, ranks) for r in range(ranks)]
    assert [len(b["left"]) for b in blocks] == [6 // ranks] * ranks
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([b[k] for b in blocks]), v)
    with pytest.raises(ValueError, match="does not divide"):
        local_slice(4, 0, 3)


def test_two_ranks_of_the_loader_load_one_processs_batches():
    """Two epochs of 3 global batches of 2 augmented clips: rank r's batch
    is clip r of the one-process batch, bit for bit."""
    aug = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4,
           "saturation_range": (0.0, 1.4)}
    ds = tds.SyntheticStereoDataset(aug, num_seqs=6, sample_len=2, height=48, width=80)
    whole = PrefetchLoader(ds, batch_size=2, num_workers=2, seed=3)
    ranks = [PrefetchLoader(ds, batch_size=2, num_workers=1, seed=3, data_rank=r, data_size=2)
             for r in range(2)]
    for _ in range(2):
        got = [list(r) for r in ranks]
        want = list(whole)
        assert len(want) == len(got[0]) == len(got[1]) == 3
        for w, *parts in zip(want, *got):
            for k in w:
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), w[k])
    first = next(iter(tds.fetch_dataloader(crop_size=(32, 48), sample_len=2, batch_size=2,
                                           num_workers=1, data_rank=1, data_size=2)))
    assert first["left"].shape == (1, 2, 32, 48, 3)


# ----------------------------------------------------------------- the loss
def test_loss_shares_add_up_to_the_global_loss():
    rng = np.random.default_rng(0)
    n, b, t, h, w = 4, 2, 2, 8, 12
    preds = rng.normal(0, 20, (n, b, t, h, w, 1)).astype(np.float32)
    uncs = rng.random(preds.shape).astype(np.float32)
    gt = rng.normal(0, 20, (b, t, h, w, 2)).astype(np.float32)
    valid = np.ones((b, t, h, w), np.float32)
    valid[0] = rng.random((t, h, w)) < 0.03  # clip 0 almost all invalid
    gt[1, 0, 0, :3, 0] = 900.0  # and past max_flow in clip 1
    jl, jm = jsequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid),
                            uncertainties=jnp.asarray(uncs))
    jl = float(jl)
    results = run_group(workers.loss_shares, 2, (preds, gt, valid, uncs), timeout_s=120)
    shares = sum(share for share, _, _ in results)
    assert abs(shares - jl) <= LOSS_SHARE_TOL * abs(jl), (shares, jl)
    for _, metrics, _ in results:
        assert set(metrics) == {"epe", "1px", "3px", "5px"}
        for k in ("epe", "1px", "3px", "5px"):
            assert metrics[k] == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), k
    mean_of_means = np.mean([alone for _, _, alone in results])
    assert abs(mean_of_means - jl) > LOSS_SHARE_TOL * abs(jl)


# ------------------------------------------------------------ the train step
def test_data_parallel_step_matches_the_jax_step_on_the_global_batch(record_property):
    flat, tree = load_anchor()
    batch = _global_batch(2, 3, 64, 128)
    ds_kwargs = dict(model_name="dynamicstereo", sample_len=3, train_iters=1,
                     mixed_precision=False)
    ds_batch = _global_batch(2, 3, 64, 128)
    with ThreadPoolExecutor(1) as pool:  # the processes run while JAX compiles
        group = pool.submit(run_group, workers.train_steps, 2,
                            (str(ANCHOR), batch, ds_batch, ds_kwargs), timeout_s=400, threads=2)
        # the anchor's 5-frame time embedding
        jax_run, jax_metrics = tp.jax_ppm_step(tree, batch)
        ranks = group.result()

    for rank, res in enumerate(ranks):
        metrics, grads, params = res["sound"]
        readings = tp.check_step(jax_run, (metrics["loss"], grads, params, None), flat)
        record_property(f"rank{rank}", readings)
        # the bad-pixel rates are counts of 2 x 3 x 64 x 128 pixels: one
        # pixel either side of a threshold moves a rate by 1 / 49152 x 100
        assert metrics["epe"] == pytest.approx(jax_metrics["epe"], rel=tp.LOSS_TOL)
        for k in ("1px", "3px", "5px"):
            assert abs(metrics[k] - jax_metrics[k]) <= 100 * 2 / 49152, k
    for k, v in ranks[0]["sound"][2].items():
        np.testing.assert_array_equal(ranks[1]["sound"][2][k], v, err_msg=k)

    # the fault: the batch mean over each rank's own clip
    metrics, grads, params = ranks[0]["local_mean"]
    with pytest.raises(AssertionError):
        tp.check_step(jax_run, (metrics["loss"], grads, params, None), flat)
    record_property("local_mean_grad_error", tp.grad_error(grads, jax_run[1])[0])

    want_metrics, want_grads, want_params = workers.one_process_step(ds_kwargs, ds_batch)
    for res in ranks:
        metrics, grads, params = res["dynamicstereo"]
        assert metrics["loss"] == pytest.approx(want_metrics["loss"], rel=DS_REL_TOL)
        assert set(grads) == set(want_grads)
        assert tp.grad_error(grads, want_grads)[0] <= DS_REL_TOL
        worst, share = tp.update_error(params, want_params, want_grads)
        assert worst <= 2.01 and share <= tp.UPDATE_SHARE, (worst, share)
