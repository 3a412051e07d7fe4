"""Device selection with no silent CPU fallback, precision settings, and
cuDNN's algorithm choice for f32 convolutions."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or implied) and there is no
    card; the CPU is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_precision() -> None:
    """Float32 means float32 on the card: no TF32 in matrix products or in
    cuDNN convolutions (cuDNN's default would be TF32). The bf16 policy of
    the model is explicit in its modules, not left to these flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextmanager
def cudnn_autotune(enabled: bool = True):
    """Run the enclosed convolutions with cuDNN's benchmark mode (each
    algorithm chosen by timing, once per shape, then cached for the
    process). Without it cuDNN picks by a heuristic, which for some f32
    convolutions without TF32 is an FFT algorithm: RAFT-Stereo's 1/4 GRU
    conv (384 -> 128, 3x3, on 10 x 80 x 128) took 351.5 ms a call and 28 GB
    of workspace that way, 2.6 ms timed, and a RAFT-Stereo window of 10
    frames at 320x512 34.1 s against 0.69 s (NVIDIA H100 80GB HBM3,
    700.00 W; tools/f32_convs.py). The search costs the first call of a
    shape (9.5 s for that window). The f32 baselines run under it;
    `enabled=False` leaves the setting as it is."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = saved or enabled
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved
