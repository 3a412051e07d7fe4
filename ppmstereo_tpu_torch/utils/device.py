"""Device selection with no silent CPU fallback, and precision settings."""

from __future__ import annotations

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
