"""Train state: the optimiser, its schedule and the frozen-backbone
partition (counterpart of ppmstereo_tpu/train/state.py::make_optimizer).

The JAX package's optimiser is an optax chain, reproduced here:

  * three partitions by parameter name: `frozen` (no update, no decay),
    `no_decay` (`sst.time_embed`) and `train` (everything else). Frozen
    are the pretrained backbones every model of the zoo holds fixed: the
    context net's ConvNeXt (`cnet.convnext.*`, the JAX partition), and
    the parts the JAX models hold fixed by `stop_gradient` only, which run
    without autograd here: PPMStereo-VDA's Video-Depth-Anything
    (`backbone.*`), StereoAnyVideo's (`depthnet.depthanything.*`) and
    BiDAStereo's RAFT (`raft.*`). The JAX optimiser leaves those three in
    its `train` partition, so its AdamW decays them by lr * wd * p every
    step though their gradient is zero; the port keeps them bit-equal, as
    the reference's frozen modules are (ROADMAP §3);
  * each of `train` and `no_decay` clips ITS OWN global gradient norm to
    0.99 (`optax.multi_transform` gives each partition its own
    `clip_by_global_norm`), then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay 1e-5 on `train`, 0 on `no_decay`);
  * the learning rate is optax's `linear_onecycle_schedule(num_steps + 100,
    lr, pct_start=0.01, pct_final=1.0)`, evaluated at the number of updates
    applied so far (`onecycle_lr`);
  * `optax.apply_if_finite(max_consecutive_errors=10)` around it all: an
    update whose gradients are not all finite is skipped and leaves the
    optimiser's state (moments, update count) as it was; after more than 10
    consecutive skips the update is applied anyway. Nothing raises.

torch's AdamW computes the same update as optax's adamw:
p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

FROZEN_PREFIXES = ("cnet.convnext.", "backbone.", "depthnet.depthanything.", "raft.")
NO_DECAY = ("sst.time_embed",)
WEIGHT_DECAY = 1e-5
CLIP_NORM = 0.99
MAX_CONSECUTIVE_ERRORS = 10


def onecycle_lr(count: int, num_steps: int, lr: float = 3e-4) -> float:
    """optax.linear_onecycle_schedule(transition_steps=num_steps + 100,
    peak_value=lr, pct_start=0.01, pct_final=1.0, div_factor=25,
    final_div_factor=1e4) at step `count`.

    With pct_final = 1.0 optax's boundary dict names `transition_steps`
    twice and keeps the later scale, so the rate rises linearly from lr / 25
    to lr over int(0.01 (num_steps + 100)) steps, falls linearly to
    lr * 1e-4 at num_steps + 100 and stays there."""
    total = num_steps + 100
    bounds = (0, int(0.01 * total), total)
    values = np.cumprod([lr / 25.0, 25.0, 1e-4])
    if count >= bounds[2]:
        return float(values[2])
    i = 0 if count < bounds[1] else 1
    pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
    return float(pct * values[i + 1] + (1 - pct) * values[i])


def param_label(name: str) -> str:
    """The optax partition of a parameter: frozen, no_decay or train."""
    if name.startswith(FROZEN_PREFIXES):
        return "frozen"
    if name in NO_DECAY:
        return "no_decay"
    return "train"


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: g <- g / |g| * max_norm when the
    global norm |g| of the group is not below max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


class TrainOptimizer:
    """AdamW over the `train` and `no_decay` partitions of `model`, each
    with its own gradient clip, the one-cycle schedule and the finite guard.
    Freezes the `frozen` partition (requires_grad False), so the backward
    pass computes no gradient for it: the guard reads the gradients of the
    trainable parameters (optax's reads the frozen partition's too)."""

    def __init__(self, model: nn.Module, num_steps: int = 200_000, lr: float = 3e-4):
        self.num_steps = num_steps
        self.lr = lr
        groups: dict[str, list[nn.Parameter]] = {"train": [], "no_decay": [], "frozen": []}
        for name, p in model.named_parameters():
            groups[param_label(name)].append(p)
        for p in groups["frozen"]:
            p.requires_grad_(False)
        self.groups = [groups["train"], groups["no_decay"]]
        self.adamw = torch.optim.AdamW(
            [{"params": groups["train"], "weight_decay": WEIGHT_DECAY},
             {"params": groups["no_decay"], "weight_decay": 0.0}],
            lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0            # updates applied: the schedule's step
        self.notfinite_count = 0  # consecutive skipped updates
        self.total_notfinite = 0

    def gradients(self) -> list[torch.Tensor]:
        """The .grad of every parameter this optimiser updates, in a fixed
        order; an unused parameter's is zero-filled first (a zero gradient,
        as in JAX), so every rank of a mesh holds the same list."""
        grads = []
        for group in self.groups:
            for p in group:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        return grads

    def step(self) -> bool:
        """Apply (or skip) one update from the parameters' .grad, then clear
        them. Returns whether the update was applied. Over a mesh the
        gradients must be the reduced ones (`train/step.py`): the finite
        guard and the clips then take the same decision on every rank."""
        grads = self.gradients()
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        applied = finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS
        if applied:
            for group in self.groups:
                if group:
                    _clip_by_global_norm([p.grad for p in group], CLIP_NORM)
            lr = onecycle_lr(self.count, self.num_steps, self.lr)
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
            self.count += 1
        self.adamw.zero_grad(set_to_none=True)
        return applied

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = state["count"]
        self.notfinite_count = state["notfinite_count"]
        self.total_notfinite = state["total_notfinite"]


class TrainState:
    """The model, its optimiser, whether the model has an uncertainty head
    (`build_train_model`'s second output: a model without one returns its
    predictions alone), the number of train steps taken and the process
    group of the ranks that hold the global batch between them, data x seq
    (`parallel/mesh.py::Mesh.replica_group`; None in one process): the
    train step's loss is then the global batch's and its gradients are
    summed over the group."""

    def __init__(self, model: nn.Module, optimizer: TrainOptimizer,
                 has_uncertainty: bool, step: int = 0, replica_group=None):
        self.model = model
        self.optimizer = optimizer
        self.has_uncertainty = has_uncertainty
        self.step = step
        self.replica_group = replica_group
        self.staging: dict = {}  # pinned host buffers of the gradient all-reduce
