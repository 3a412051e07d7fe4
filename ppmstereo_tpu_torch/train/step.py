"""One training step (counterpart of ppmstereo_tpu/train/step.py::
make_train_step): the train-mode forward over every refinement iteration,
the sequence loss with its uncertainty term, the backward pass and one
update of the optimiser. Models without an uncertainty head (DynamicStereo,
BiDAStereo, StereoAnyVideo) return their predictions alone; the loss then
has no uncertainty term, as under the JAX trainer's `_wrap_no_uncertainty`.

Over the mesh's data and seq axes (`state.replica_group`, data x seq
ranks: each holds its block of the global batch's clips and of their
frames) each rank's loss is its share of the global batch's, and the
gradients are summed over the group after the backward pass, before the
optimiser reads them: what one process computes on the global batch, as
XLA's all-reduce gives the JAX trainer. The sum runs after `backward()`,
not overlapped with it, so it cannot interleave with the messages that
the checkpointed iterations issue again in the backward pass (the batch
mean over data, the frame gathers and time halos over seq) or with the
cotangents that the gathers and halos send back."""

from __future__ import annotations

import torch

from ppmstereo_tpu_torch.parallel.collectives import all_reduce_, host_staged
from ppmstereo_tpu_torch.train.loss import sequence_loss
from ppmstereo_tpu_torch.train.state import TrainState

BATCH_KEYS = ("left", "right", "disparity", "valid")


def predictions(state: TrainState, left: torch.Tensor, right: torch.Tensor):
    """The train-mode forward of `state.model`: (predictions, uncertainties),
    the latter None for a model without an uncertainty head."""
    out = state.model(left, right)
    return out if state.has_uncertainty else (out, None)


def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
    """batch: left/right (B, T, H, W, 3) in [0, 255], disparity
    (B, T, H, W, 1), valid (B, T, H, W), tensors on the model's device.

    Updates `state` in place and returns it with the metrics (epe, 1px,
    3px, 5px, loss) as 0-d tensors; reading them waits for the device."""
    preds, uncs = predictions(state, batch["left"], batch["right"])
    loss, metrics = sequence_loss(preds, batch["disparity"], batch["valid"],
                                  uncertainties=uncs, group=state.replica_group)
    loss.backward()
    loss = loss.detach()
    if state.replica_group is not None:
        all_reduce_gradients(state)
        loss = all_reduce_(loss.clone(), state.replica_group)  # the shares' sum
    state.optimizer.step()
    state.step += 1
    return state, dict(metrics, loss=loss)


def all_reduce_gradients(state: TrainState) -> None:
    """Sum the gradients of every parameter the optimiser updates over
    `state.replica_group` (data x seq), in one message per dtype (under gloo on a card through a
    pinned host buffer that `state.staging` keeps for the next step).
    Frozen parameters have none and take no part; an unused one's
    zero-filled gradient does, so every rank sends the same message.
    REDUCED counts the calls and the bytes this process reduced."""
    by_dtype: dict = {}
    for g in state.optimizer.gradients():
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, grads in by_dtype.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        host = None
        if host_staged(state.replica_group, flat.device):
            host = state.staging.get(dtype)
            if host is None or host.numel() != flat.numel():
                host = state.staging[dtype] = torch.empty(flat.shape, dtype=dtype,
                                                          pin_memory=True)
        all_reduce_(flat, state.replica_group, host)
        start = 0
        for g in grads:
            g.copy_(flat[start: start + g.numel()].view_as(g))
            start += g.numel()
        REDUCED["bytes"] += flat.numel() * flat.element_size()
    REDUCED["calls"] += 1


REDUCED = {"calls": 0, "bytes": 0}


def to_device(batch: dict, device: torch.device) -> dict:
    """A loader's numpy batch as f32 tensors on `device`."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32).to(device, non_blocking=True)
            for k in BATCH_KEYS}
