"""Profiling and roofline accounting (counterpart of
ppmstereo_tpu/utils/profiling.py).

  * `trace(logdir)`: a context manager around torch.profiler that writes a
    Chrome trace (`*.pt.trace.json`, viewable in Perfetto or TensorBoard)
    into `logdir`;
  * `timed(name, results, device)`: wall-clock timing that synchronises a
    CUDA device before it reads the clock on exit;
  * `OpCost` and the analytic FLOP and byte counts of the hot ops, to set a
    measured time beside the card's envelope. The counts are the JAX
    package's formulas; the peaks are the H100 SXM's.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

# NVIDIA H100 SXM peaks: dense bf16 tensor-core rate and HBM3 rate
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host ops, and the card's kernels when CUDA is
    available) and write its Chrome trace into `logdir` as
    `trace_<pid>_<ns>.pt.trace.json`; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def timed(name: str, results: dict | None = None, device: torch.device | str | None = None):
    """Seconds of the block into `results[name]` (printed when `results` is
    None). With a CUDA `device` the device is synchronised before the clock
    is read on exit, so the block's queued kernels are counted."""
    device = torch.device(device) if device is not None else None
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"[timed] {name}: {dt * 1e3:.2f} ms")


@dataclass
class OpCost:
    flops: float
    bytes: float

    @property
    def compute_s(self) -> float:
        return self.flops / H100_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes / H100_HBM_BYTES_S

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s > self.memory_s else "memory"

    @property
    def light_speed_s(self) -> float:
        return max(self.compute_s, self.memory_s)


def corr_volume_cost(b, h, w1, w2, c, bytes_per=2) -> OpCost:
    return OpCost(
        flops=2.0 * b * h * w1 * w2 * c,
        bytes=bytes_per * b * h * (w1 * c + w2 * c + w1 * w2 * 2),
    )


def corr_lookup_cost(b, h, w1, w2, taps=36, bytes_per=4) -> OpCost:
    # one-hot masked reduction: compare+select+mul+add over W2 per tap
    levels_scale = 1.875  # sum of W2/2^i over 4 levels
    return OpCost(
        flops=4.0 * b * h * w1 * w2 * taps / 4 * levels_scale,
        bytes=bytes_per * b * h * (w1 * w2 * levels_scale + w1 * taps),
    )


def play_attention_cost(b, t, hw, k, c, bytes_per=2) -> OpCost:
    lk = k * hw
    return OpCost(
        flops=4.0 * b * t * hw * lk * c,
        bytes=bytes_per * b * t * (hw * c * 2 + 2 * lk * c),
    )


def gru3d_cost(b, t, h, w, hidden, inp, taps=45, bytes_per=2) -> OpCost:
    # 9 separable convs over (t,h,w); taps ~ total kernel footprint
    cin = hidden + inp
    return OpCost(
        flops=2.0 * b * t * h * w * hidden * cin * taps / 9,
        bytes=bytes_per * b * t * h * w * (cin + hidden) * 9,
    )


def ppm_iteration_cost(b, t, h, w, c=128, top_k=5) -> OpCost:
    """One pick-and-play iteration at one scale: the lookup, the play and
    the GRU."""
    costs = [
        corr_lookup_cost(b * t, h, w, w),
        play_attention_cost(b, t, h * w, top_k, c),
        gru3d_cost(b, t, h, w, c, 256 + 1),
    ]
    return OpCost(sum(x.flops for x in costs), sum(x.bytes for x in costs))
