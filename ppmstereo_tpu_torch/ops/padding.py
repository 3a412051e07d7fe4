"""Pad video frames so H and W divide 32, the stride of the context net's
deepest (1/32) level.

Counterpart of ppmstereo_tpu/ops/padding.py with its default 'sintel'
geometry (split top/bottom, left/right) and replicate padding on
(..., H, W, C) tensors.
"""

from __future__ import annotations

import torch

DIVIS_BY = 32


class InputPadder:
    def __init__(self, ht: int, wd: int):
        self.ht, self.wd = ht, wd
        pad_ht = -ht % DIVIS_BY
        pad_wd = -wd % DIVIS_BY
        # (left, right, top, bottom)
        self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)

    @property
    def padded_hw(self) -> tuple[int, int]:
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r

    def pad(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        """Pad (..., H, W, C) tensors by repeating their edge rows/columns."""
        l, r, t, b = self._pad
        out = []
        for x in inputs:
            h, w = x.shape[-3], x.shape[-2]
            rows = torch.arange(-t, h + b, device=x.device).clamp(0, h - 1)
            cols = torch.arange(-l, w + r, device=x.device).clamp(0, w - 1)
            x = x.index_select(x.dim() - 3, rows)
            out.append(x.index_select(x.dim() - 2, cols))
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        h, w = x.shape[-3], x.shape[-2]
        return x[..., t : h - b, l : w - r, :]
