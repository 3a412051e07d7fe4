"""Checkpoints of a training run (counterpart of
ppmstereo_tpu/train/checkpoints.py::CheckpointManager, without Orbax).

A checkpoint is one `torch.save` file, `<dir>/step_<n>.pt`, holding the
model's parameters, the optimiser's state (AdamW moments, the schedule's
update count, the finite guard's counters) and the train step; the newest
`max_to_keep` are kept. A file is written to a temporary name and renamed
into place, so an interrupted save leaves no partial checkpoint.
`export_npz` (utils/weights.py) writes the parameters in the anchor's flat
npz format for either package's `model_zoo`.

Over a data axis only rank 0 writes (`write=True`); every rank reads a
resume from the same files.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from ppmstereo_tpu_torch.train.state import TrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    """write=False: a reader only (a rank other than 0 of a data axis); it
    creates no directory and `save` writes nothing."""

    def __init__(self, ckpt_dir: str | Path, max_to_keep: int = 5, write: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.write = write
        if write:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        if not self.ckpt_dir.is_dir():
            return []
        found = (_NAME.search(p.name) for p in self.ckpt_dir.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: TrainState) -> Path | None:
        if not self.write:
            return None
        path = self.ckpt_dir / f"step_{state.step}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.ckpt_dir / f"step_{old}.pt").unlink()
        return path

    def restore(self, state: TrainState) -> bool:
        """Load the newest checkpoint into `state`; False when there is none."""
        steps = self.steps()
        if not steps:
            return False
        saved = torch.load(self.ckpt_dir / f"step_{steps[-1]}.pt",
                           map_location=next(state.model.parameters()).device,
                           weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = saved["step"]
        return True
