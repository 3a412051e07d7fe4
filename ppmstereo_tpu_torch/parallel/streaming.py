"""Sliding windows spread over the `data` axis (counterpart of
ppmstereo_tpu/parallel/streaming.py::ParallelWindowPredictor).

Windows are independent given the trim arithmetic, so they are packed
`data` at a time into one batch whose clips spread over the axis: each rank
runs its block of the batch, and the outputs are all-gathered so every
rank stitches the whole video. The packing is the JAX package's: a short
chunk of full windows is filled up with copies of the clip's first window,
a tail window (shorter than the kernel) runs alone, copied to `data`
windows. The filling windows are computed like the others, so they enter a
batch statistic such as PPMStereo's batch mean of the picked scores, as
under XLA's sharding; they also keep every rank issuing the same
collectives, since a rank with no window would leave its group waiting.

Every rank of the mesh calls the predictor on the same video. Under
data x seq the window function is a model on the mesh: each data rank's
block of windows spreads its frames over that rank's seq group (the JAX
package's P("data", "seq", "space"), with its rule: a window whose length
the seq axis does not divide runs whole on every rank of the axis).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ppmstereo_tpu_torch.models.inference import window_trim_bounds
from ppmstereo_tpu_torch.ops.padding import InputPadder
from ppmstereo_tpu_torch.parallel.collectives import all_gather
from ppmstereo_tpu_torch.parallel.sharding import local_slice


class ParallelWindowPredictor:
    """The batched sliding-window predictor over a mesh's `data` axis.

    window_fn(left, right) takes (B, T, H, W, 3) tensors on `device` (this
    rank's block of the batch, H and W padded to multiples of 32)
    and returns (disparity, uncertainty), each (B, T, H, W, 1). Returns
    {"disparity", "uncertainties"}: (N, H, W, 1) numpy, absolute values."""

    def __init__(self, window_fn: Callable, mesh, kernel_size: int = 20,
                 device: torch.device | str = "cuda"):
        self.window_fn = window_fn
        self.mesh = mesh
        self.kernel_size = kernel_size
        self.device = torch.device(device)
        self.windows_per_step = int(mesh.shape["data"])

    @torch.no_grad()
    def _run_batch(self, lefts: np.ndarray, rights: np.ndarray):
        """lefts/rights (B, T, H, W, 3): B windows; B is filled up to a
        multiple of `data` with copies of the last. Returns the B windows'
        (disparity, uncertainty) as numpy, on every rank."""
        dp = self.windows_per_step
        orig_b = lefts.shape[0]
        if orig_b % dp:
            pad = dp - orig_b % dp
            lefts = np.concatenate([lefts, np.repeat(lefts[-1:], pad, 0)])
            rights = np.concatenate([rights, np.repeat(rights[-1:], pad, 0)])
        mine = local_slice(lefts.shape[0], self.mesh.coords["data"], dp)
        padder = InputPadder(lefts.shape[2], lefts.shape[3])
        left, right = (torch.as_tensor(x[mine], dtype=torch.float32).to(self.device)
                       for x in (lefts, rights))
        outs = self.window_fn(*padder.pad(left, right))
        group = self.mesh.groups["data"]
        outs = [padder.unpad(o.float()) for o in outs]
        if group is not None:
            outs = [all_gather(o.contiguous(), group, dim=0) for o in outs]
        return tuple(o[:orig_b].cpu().numpy() for o in outs)

    def __call__(self, stereo_video) -> dict[str, np.ndarray]:
        video = np.asarray(stereo_video, dtype=np.float32)
        num_ims = len(video)
        k = self.kernel_size
        stride = k // 2
        if k > num_ims:
            disp, unc = self._run_batch(video[None, :, 0], video[None, :, 1])
            return {"disparity": np.abs(disp[0]), "uncertainties": np.abs(unc[0])}

        wins = []
        for i in range(0, num_ims, stride):
            wlen = min(i + k, num_ims) - i
            if i > 0 and wlen < stride:
                continue
            wins.append((i, wlen))
        full = [w for w in wins if w[1] == k]
        tails = [w for w in wins if w[1] != k]

        results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        bsz = self.windows_per_step
        for s in range(0, len(full), bsz):
            chunk = full[s: s + bsz]
            fill = bsz - len(chunk)
            lefts = np.stack([video[i: i + k, 0] for i, _ in chunk] + [video[:k, 0]] * fill)
            rights = np.stack([video[i: i + k, 1] for i, _ in chunk] + [video[:k, 1]] * fill)
            disp, unc = self._run_batch(lefts, rights)
            for j, (i, _) in enumerate(chunk):
                results[i] = (disp[j], unc[j])
        for i, wlen in tails:
            disp, unc = self._run_batch(video[None, i: i + wlen, 0], video[None, i: i + wlen, 1])
            results[i] = (disp[0], unc[0])

        disp_parts, unc_parts = [], []
        for i, wlen in wins:
            disp, unc = results[i]
            lo, hi = window_trim_bounds(i, wlen, k, stride)
            disp_parts.append(disp[lo: len(disp) - hi])
            unc_parts.append(unc[lo: len(unc) - hi])
        return {"disparity": np.abs(np.concatenate(disp_parts)),
                "uncertainties": np.abs(np.concatenate(unc_parts))}
