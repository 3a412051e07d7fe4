"""Training StereoAnyVideo (`--name stereoanyvideo`): one port train step
against the JAX trainer's (tests/torch_train_parity.py: the loss, every
trainable gradient, the updated parameters, the frozen Video-Depth-Anything
backbone bit-equal), a wrong forward that must fail the limits, and the
checkpointed iteration pairs against the unchecked forward.

Weights: the port's seeded initialisation carried to the JAX model
(tests/torch_train_parity.py), with the zero-initialised leaves drawn (the
motion modules' `proj_out`, the temporal attention's `temporal_fc`; as
tests/test_torch_stereoanyvideo.py). Input: a (1, 2, 64, 128) synthetic
batch (the backbone sees 56x126), 2 iterations: 1 + 1 + 2 over the three
scales, so the 1/16 and 1/8 scales run one plain (1, 9) iteration each
(the tail of an odd count) and the 1/4 scale one checkpointed (1, 9) +
(3, 3) pair, as the JAX scan with its remat does. Both packages run every
operation in f32.
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.models import stereoanyvideo as tsav
from ppmstereo_tpu_torch.train.loss import sequence_loss
from ppmstereo_tpu_torch.train.step import predictions, to_device
from ppmstereo_tpu_torch.utils.weights import flatten_params
from tests import torch_train_parity as tp
from tests.test_torch_vda import draw_proj_out
from tests.torch_zoo_parity import draw_zero_leaves

torch.set_num_threads(2)
FRAMES, H, W, ITERS = 2, 64, 128, 2


@pytest.fixture(scope="module")
def run():
    b = tp.batch(FRAMES, H, W, seed=4)
    jcfg, tcfg = tp.configs("stereoanyvideo", FRAMES, ITERS)
    tree = draw_proj_out(draw_zero_leaves(tp.init_tree(tcfg, seed=4), seed=4), seed=4)
    flat = flatten_params(tree)
    return dict(batch=b, tcfg=tcfg, flat=flat, jax=tp.jax_step(jcfg, tree, b),
                port=tp.port_step(tcfg, flat, b))


def test_train_step_matches_jax(run, record_property):
    readings = tp.check_step(run["jax"], run["port"], run["flat"])
    for name, value in readings.items():
        record_property(name, value)
    assert readings["significant"] > 50
    model = run["port"][3]
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen and all(n.startswith("depthnet.depthanything.") for n in frozen)
    assert all(p.requires_grad for p in model.depthnet.conv.parameters())  # the adapter trains


def test_unalternating_patch_fails_the_limits(run, monkeypatch, record_property):
    """The fault: AAPC's patch not alternating (always (1, 9))."""
    aapc = tsav.aapc_correlation
    monkeypatch.setattr(tsav, "aapc_correlation", lambda l, r, psize: aapc(l, r, (1, 9)))
    loss, grads, _, _ = tp.port_step(run["tcfg"], run["flat"], run["batch"])
    jl, jg, _ = run["jax"]
    assert abs(loss - jl) > tp.LOSS_TOL * abs(jl)
    fault = tp.grad_error(grads, jg, encoders=False)[0]
    record_property("fault_grad_error", fault)
    assert fault > tp.GRAD_TOL


def test_wrong_encoder_norm_fails_the_encoder_limit(run, record_property):
    tp.check_encoder_norm_fault(run, record_property)


def _forward_backward(run):
    model, has_unc = tp.port_model(run["tcfg"], run["flat"])
    b = to_device(run["batch"], torch.device("cpu"))
    preds, uncs = predictions(tp.TrainState(model, tp.TrainOptimizer(model), has_unc),
                              b["left"], b["right"])
    assert uncs is None
    sequence_loss(preds, b["disparity"], b["valid"])[0].backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return preds.detach(), grads


def test_checkpointed_pairs_match_the_unchecked_forward(run, monkeypatch):
    """Train mode runs each iteration pair under torch.utils.checkpoint;
    with the checkpoint a plain call, the predictions are the same bits and
    the gradients the same to f32 rounding (1e-6 of each tensor's norm:
    the recomputation adds up the shared update block's gradients in
    another order)."""
    calls = []
    checkpoint = tsav.checkpoint
    monkeypatch.setattr(tsav, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn.__name__) or checkpoint(fn, *a, **k))
    preds, grads = _forward_backward(run)
    assert calls == ["_pair"]  # 1/16 and 1/8: one plain iteration each; 1/4: a pair
    monkeypatch.setattr(tsav, "checkpoint", lambda fn, *a, **k: fn(*a))
    want_preds, want_grads = _forward_backward(run)
    assert preds.shape == (4, 1, FRAMES, H, W, 1)
    torch.testing.assert_close(preds, want_preds, rtol=0, atol=0)
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        err = float((g - want_grads[n]).norm() / want_grads[n].norm().clamp_min(1e-30))
        assert err <= 1e-6, (n, err)


def test_frozen_backbone_runs_without_autograd(run):
    """The backbone's features carry no graph: its tensors get no gradient
    and stay out of the optimiser's groups."""
    model = run["port"][3]
    opt_params = {id(p) for group in tp.TrainOptimizer(model).adamw.param_groups
                  for p in group["params"]}
    for n, p in model.named_parameters():
        assert (id(p) in opt_params) != n.startswith("depthnet.depthanything.")
    assert np.isfinite(run["port"][0])
