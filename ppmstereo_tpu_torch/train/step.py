"""One training step (counterpart of ppmstereo_tpu/train/step.py::
make_train_step): the train-mode forward over every refinement iteration,
the sequence loss with its uncertainty term, the backward pass and one
update of the optimiser."""

from __future__ import annotations

import torch

from ppmstereo_tpu_torch.train.loss import sequence_loss
from ppmstereo_tpu_torch.train.state import TrainState

BATCH_KEYS = ("left", "right", "disparity", "valid")


def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
    """batch: left/right (B, T, H, W, 3) in [0, 255], disparity
    (B, T, H, W, 1), valid (B, T, H, W), tensors on the model's device.

    Updates `state` in place and returns it with the metrics (epe, 1px,
    3px, 5px, loss) as 0-d tensors; reading them waits for the device."""
    model = state.model
    preds, uncs = model(batch["left"], batch["right"])
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
