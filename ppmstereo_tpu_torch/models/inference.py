"""Strict sliding-window inference over stereo videos of any length.

Counterpart of ppmstereo_tpu/models/inference.py for cold, strict windows:
overlapping windows of `kernel_size` frames with stride kernel_size // 2,
each padded to a multiple of 32, stitched by trimming the window edges, and
|disparity| as output. A video shorter than one window runs as one window.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ppmstereo_tpu_torch.ops.padding import InputPadder

_OUTPUTS = ("disparity", "uncertainties")


def window_trim_bounds(i: int, wlen: int, k: int, stride: int) -> tuple[int, int]:
    """Frames (lo, hi) trimmed from the start and the end of the window
    that starts at frame i.

    The reference trims `[stride//2 : -stride//2]`, and Python floors the
    negative division (-5 // 2 == -3), so the trailing trim is
    ceil(stride / 2): that asymmetry is what makes odd strides tile exactly.
    """
    tail = (stride + 1) // 2
    if i == 0:
        return 0, tail
    if wlen < k:
        return stride // 2, 0
    return stride // 2, tail


class SlidingWindowPredictor:
    """Drives a test-mode window function over long videos.

    window_fn(left, right) -> (disparity (1,T,H,W,1), uncertainty like it),
    with left/right (1, T, H, W, 3) in [0, 255] on `device`.
    """

    def __init__(self, window_fn: Callable, kernel_size: int = 20,
                 device: torch.device | str = "cuda"):
        self.window_fn = window_fn
        self.kernel_size = kernel_size
        self.device = torch.device(device)

    @torch.no_grad()
    def _run_window(self, left: torch.Tensor, right: torch.Tensor):
        """left/right (T, H, W, 3) -> tuple of (T, H, W, 1) outputs, without
        autograd."""
        _, h, w, _ = left.shape
        padder = InputPadder(h, w)
        lp, rp = padder.pad(left, right)
        outs = self.window_fn(lp[None], rp[None])
        return tuple(padder.unpad(o[0]) for o in outs)

    def __call__(self, stereo_video) -> dict[str, np.ndarray]:
        """stereo_video: (N, 2, H, W, 3) in [0, 255] (numpy or tensor).

        Returns {"disparity": (N, H, W, 1), "uncertainties": (N, H, W, 1)}
        as f32 numpy, disparity as absolute values."""
        video = torch.as_tensor(np.asarray(stereo_video), dtype=torch.float32)
        video = video.to(self.device)
        num_ims = video.shape[0]
        k = self.kernel_size
        stride = k // 2

        if k > num_ims:
            outs = self._run_window(video[:, 0], video[:, 1])
            return {nm: np.abs(o.float().cpu().numpy())
                    for nm, o in zip(_OUTPUTS, outs)}

        parts: list[list[np.ndarray]] = [[] for _ in _OUTPUTS]
        for i in range(0, num_ims, stride):
            j = min(i + k, num_ims)
            wlen = j - i
            if i > 0 and wlen < stride:
                continue  # the reference skips tails shorter than a stride
            outs = self._run_window(video[i:j, 0], video[i:j, 1])
            lo, hi = window_trim_bounds(i, wlen, k, stride)
            for dst, o in zip(parts, outs):
                dst.append(o[lo: o.shape[0] - hi].float().cpu().numpy())
        return {nm: np.abs(np.concatenate(plist))
                for nm, plist in zip(_OUTPUTS, parts)}
