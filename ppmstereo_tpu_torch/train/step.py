"""One training step (counterpart of ppmstereo_tpu/train/step.py::
make_train_step): the train-mode forward over every refinement iteration,
the sequence loss with its uncertainty term, the backward pass and one
update of the optimiser. Models without an uncertainty head (DynamicStereo,
BiDAStereo, StereoAnyVideo) return their predictions alone; the loss then
has no uncertainty term, as under the JAX trainer's `_wrap_no_uncertainty`."""

from __future__ import annotations

import torch

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
                                  uncertainties=uncs)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, dict(metrics, loss=loss.detach())


def to_device(batch: dict, device: torch.device) -> dict:
    """A loader's numpy batch as f32 tensors on `device`."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32).to(device, non_blocking=True)
            for k in BATCH_KEYS}
