"""Training metrics: running means flushed to an append-only JSONL file,
and to TensorBoard when it can be imported (counterpart of
ppmstereo_tpu/utils/logging_utils.py::MetricsLogger). A logger with
write=False (a rank other than 0 of a data axis) writes nothing."""

from __future__ import annotations

import json
import os
import time

SUM_FREQ = 100


class MetricsLogger:
    def __init__(self, exp_dir: str, sum_freq: int = SUM_FREQ, write: bool = True):
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self.sum_freq = sum_freq
        self.write = write
        self._last_flush_step: int | None = None
        self.running: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.writer = None
        if not write:
            return
        os.makedirs(exp_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is optional
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir=os.path.join(exp_dir, "tb"))

    def push(self, step: int, metrics: dict) -> None:
        """Add one step's metrics; flush at the first push at least
        sum_freq steps after the previous flush (the first flush lands on
        the sum_freq grid when pushes do)."""
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1
        if self._last_flush_step is None:
            self._last_flush_step = ((step - 1) // self.sum_freq) * self.sum_freq
        if step - self._last_flush_step >= self.sum_freq:
            self.flush(step)

    def flush(self, step: int) -> None:
        self._last_flush_step = step
        if not self.running or not self.write:
            self.running.clear()
            self.counts.clear()
            return
        means = {k: self.running[k] / max(self.counts[k], 1) for k in self.running}
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(), **means}) + "\n")
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(k, v, step)
        self.running.clear()
        self.counts.clear()

    def write_dict(self, step: int, metrics: dict, prefix: str = "") -> None:
        """Write one record of `metrics` now (keys prefixed), beside the
        running means: the in-training evaluation's results."""
        if not self.write:
            return
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            rec[f"{prefix}{k}"] = float(v)
            if self.writer is not None:
                self.writer.add_scalar(f"{prefix}{k}", float(v), step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
