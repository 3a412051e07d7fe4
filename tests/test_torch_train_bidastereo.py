"""Training BiDAStereo (`--name bidastereo`): one port train step against
the JAX trainer's (tests/torch_train_parity.py: the loss, every trainable
gradient, the updated parameters, the frozen RAFT bit-equal), a wrong
forward that must fail the limits, and the frozen partition's difference
from the JAX optimiser's.

Weights: the port's seeded initialisation carried to the JAX model
(tests/torch_train_parity.py), the RAFT's FrozenBatchNorms given drawn
statistics (tests/test_torch_raft.py). Input: a (1, 3, 64, 128) synthetic batch, 2
iterations (1 + 1 + 2), the RAFT at 2 iterations (`raft_iters`, as
tests/test_torch_bidastereo.py; the shipped 10 only lengthen the frozen
part). Both packages run every operation in f32.

The frozen partition: the JAX models hold BiDAStereo's RAFT (and the VDA
backbones) fixed by `stop_gradient` alone, so the JAX optimiser keeps them
in its `train` partition and its AdamW decays them by lr * wd * p a step
though their gradient is zero; the port freezes them (train/state.py).
At the shipped lr <= 3e-4 and wd 1e-5 that decay, <= 3e-9 of p, is below
half an f32 ulp and rounds away; at a larger lr * wd it shows.
"""

import jax
import numpy as np
import pytest
import torch

from ppmstereo_tpu.train.state import make_optimizer
from ppmstereo_tpu_torch.models import bidastereo as tbida
from ppmstereo_tpu_torch.train import state as tstate
from ppmstereo_tpu_torch.utils.weights import (
    flatten_params,
    state_dict_to_flax,
    transposed_kernels,
)
from tests import torch_train_parity as tp
from tests.test_torch_raft import draw_batch_norms

torch.set_num_threads(2)
FRAMES, H, W, ITERS = 3, 64, 128, 2
KWARGS = {"raft_iters": 2}
# the feature encoders' limit, below tests/torch_train_parity.py's: JAX
# against the port reads 2.0e-3 there, the wrong encoder norm 1.3e-2
# (both recorded as junit properties)
ENCODER_GRAD_TOL = 5e-3


@pytest.fixture(scope="module")
def run():
    b = tp.batch(FRAMES, H, W, seed=3)
    jcfg, tcfg = tp.configs("bidastereo", FRAMES, ITERS, KWARGS)
    tree = draw_batch_norms(tp.init_tree(tcfg, seed=3), seed=3)
    flat = flatten_params(tree)
    return dict(batch=b, tcfg=tcfg, tree=tree, flat=flat, jax=tp.jax_step(jcfg, tree, b),
                port=tp.port_step(tcfg, flat, b))


def test_train_step_matches_jax(run, record_property):
    readings = tp.check_step(run["jax"], run["port"], run["flat"], encoder_tol=ENCODER_GRAD_TOL)
    for name, value in readings.items():
        record_property(name, value)
    assert readings["significant"] > 50
    model = run["port"][3]
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == \
        {n for n, _ in model.named_parameters() if n.startswith("raft.")}
    # the RAFT's FrozenBatchNorm statistics are buffers, in the state dict
    assert any(k.startswith("raft.") and k.endswith(".mean") for k in model.state_dict())


def test_unalternating_patch_fails_the_limits(run, monkeypatch, record_property):
    """The fault: TFCL's patch not alternating (always (1, 9)); at this
    initialisation it moves the loss by a few 1e-6 only, the gradients of
    the update block far beyond their limit."""
    tfcl = tbida.tfcl_correlation
    monkeypatch.setattr(tbida, "tfcl_correlation", lambda l, r, psize: tfcl(l, r, (1, 9)))
    _, grads, _, _ = tp.port_step(run["tcfg"], run["flat"], run["batch"])
    fault = tp.grad_error(grads, run["jax"][1], encoders=False)[0]
    record_property("fault_grad_error", fault)
    assert fault > tp.GRAD_TOL


def test_wrong_encoder_norm_fails_the_encoder_limit(run, record_property):
    tp.check_encoder_norm_fault(run, record_property, encoder_tol=ENCODER_GRAD_TOL)


@pytest.mark.parametrize("lr,wd", [(3e-4, 1e-5), (2.5e-1, 1e-1)])
def test_frozen_partition_against_the_jax_optimizer(run, lr, wd, monkeypatch):
    """One update from the step's gradients by both optimisers: the JAX
    one (make_optimizer) moves the RAFT's tensors by -lr0 wd p, which at
    the shipped lr and wd rounds to nothing in f32 and at lr0 wd = 1e-3
    shows; the port's leaves them bit-equal at both."""
    jg = run["jax"][1]
    tree = run["tree"]
    tx = make_optimizer(num_steps=tp.NUM_STEPS, lr=lr, weight_decay=wd)
    grads = jax.tree_util.tree_map(np.zeros_like, tree)
    for path, g in jg.items():
        node = grads
        *parents, leaf = path.split("/")
        for p in parents:
            node = node[p]
        node[leaf] = g
    updates, _ = tx.update(grads, tx.init(tree), tree)
    new = flatten_params(jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), tree, updates))
    lr0 = tstate.onecycle_lr(0, tp.NUM_STEPS, lr)
    start = run["flat"]
    raft = [k for k in new if k.startswith("params/raft/")]
    moved = [k for k in raft if not np.array_equal(new[k], start[k])]
    if lr0 * wd < 2.0 ** -25:  # below half an ulp of every f32 value
        assert moved == []
    else:  # weights, biases and the batch-norm statistics
        assert len(moved) > len(raft) // 2
        for k in raft:
            np.testing.assert_allclose(new[k], start[k] * (1 - lr0 * wd), rtol=1e-6, atol=0,
                                       err_msg=k)

    monkeypatch.setattr(tstate, "WEIGHT_DECAY", wd)
    model, _ = tp.port_model(run["tcfg"], start)
    opt = tstate.TrainOptimizer(model, num_steps=tp.NUM_STEPS, lr=lr)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    assert opt.step()
    after = state_dict_to_flax(model.state_dict(), transposed_kernels(model))
    for k in raft:
        np.testing.assert_array_equal(after[k], start[k], err_msg=k)
    trained = "params/fnet/Conv_1/Conv_0/kernel"
    assert not np.array_equal(after[trained], start[trained])

