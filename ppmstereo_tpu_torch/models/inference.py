"""Sliding-window inference over stereo videos of any length.

Counterpart of ppmstereo_tpu/models/inference.py: overlapping windows of
`kernel_size` frames with stride kernel_size // 2, each padded to a multiple
of 32, stitched by trimming the window edges, and |disparity| as output. A
video shorter than one window runs as one window. The JAX package's window
modes are here too:

  fast_mode       non-overlapping windows, nothing trimmed (non-parity)
  batch_windows   up to n windows of one length as one batch (strict)
  warm_window_fn  every window after the first seeded with the previous
                  window's signed disparity (non-parity)
  encode/body     per-frame encoder features of the frames two windows
  window_fn       share, reused by the next window (strict)
  align_windows   each window scale/shift-aligned onto its predecessor
                  over the shared frames (non-parity)

The warm seed and the cached features stay on the device between windows;
only each window's kept frames are copied to the host.

Under a mesh's `data` axis (`data_group`), every rank calls the predictor
on the same video, and a batch of `batch_windows` windows spreads over the
axis, as the JAX predictor's `_sharding(batched=True)` lays it out: each
rank runs its block of the batch, and the outputs are all-gathered. A batch
that the axis does not divide raises, as the JAX sharding does; a single
window, and every window of the warm and encoder-cache modes, runs whole on
every rank. Under a mesh's `seq` axis the model itself spreads each
window's frames over the axis (`models/ppm_stereo.py`; a window whose
length the axis does not divide runs whole on every rank of it) and
returns the whole window, so the predictor, its modes and its stitching
are the same; every rank calls it on the same video. The JAX package's
`wire_dtype`, `max_inflight_windows` and per-window-shape jit serve XLA and
the TPU's host link and have no counterpart here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ppmstereo_tpu_torch.ops.padding import InputPadder
from ppmstereo_tpu_torch.parallel.collectives import all_gather
from ppmstereo_tpu_torch.parallel.sharding import local_slice


def window_trim_bounds(i: int, wlen: int, k: int, stride: int,
                       fast_mode: bool = False) -> tuple[int, int]:
    """Frames (lo, hi) trimmed from the start and the end of the window
    that starts at frame i.

    The reference trims `[stride//2 : -stride//2]`, and Python floors the
    negative division (-5 // 2 == -3), so the trailing trim is
    ceil(stride / 2): that asymmetry is what makes odd strides tile exactly.
    In fast mode the windows do not overlap and nothing is trimmed.
    """
    tail = (stride + 1) // 2
    if fast_mode:
        return 0, 0
    if i == 0:
        return 0, tail
    if wlen < k:
        return stride // 2, 0
    return stride // 2, tail


def scale_shift_align(prev_overlap: np.ndarray, new_overlap: np.ndarray):
    """Least-squares (scale, shift) that maps `new` onto `prev` over the
    frames two windows share."""
    x = new_overlap.reshape(-1).astype(np.float64)
    y = prev_overlap.reshape(-1).astype(np.float64)
    var = x.var()
    if var < 1e-12:
        return 1.0, float(y.mean() - x.mean())
    a = float(((x - x.mean()) * (y - y.mean())).mean() / var)
    return a, float(y.mean() - a * x.mean())


def _warm_seed(prev: torch.Tensor, t: int, overlap: int) -> torch.Tensor:
    """The warm window's flow_init (t, H, W, 1): the previous window's last
    `overlap` frames, then its last frame repeated for the new frames."""
    tail = prev[-1:].expand(t - overlap, *prev.shape[1:])
    return torch.cat([prev[prev.shape[0] - overlap:], tail]) if overlap else tail


def _concat_feats(cached: dict | None, new: dict) -> dict:
    """Per-frame features of two windows' frames, joined along time."""
    if cached is None:
        return new
    return {name: torch.cat([cached[name], new[name]], dim=1) for name in new}


class SlidingWindowPredictor:
    """Drives a test-mode window function over long videos.

    window_fn(left, right) -> (disparity (B,T,H,W,1), uncertainty like it),
    with left/right (B, T, H, W, 3) in [0, 255] on `device` (B is 1, or the
    number of batched windows).

    warm_window_fn(left, right, flow_init): the warm window, flow_init
    (1, T, H, W, 1) signed full-resolution x-flow.

    encode_window_fn(left, right) -> per-frame features (a dict of
    (1, T, ...) tensors), body_window_fn(left, right, feats) and
    warm_body_window_fn(left, right, flow_init, feats): the model split at
    its encoders. The encoder cache is on when the split is given, windows
    overlap (not fast_mode), run one at a time (batch_windows 1), and a warm
    predictor also has its warm body.

    fetch_uncertainty=False drops the "uncertainties" output.

    data_group: the mesh's data-axis process group, over which batched
    windows spread (None: one process).
    """

    def __init__(self, window_fn: Callable, kernel_size: int = 20,
                 device: torch.device | str = "cuda", align_windows: bool = False,
                 fast_mode: bool = False, batch_windows: int = 1,
                 warm_window_fn: Callable | None = None, fetch_uncertainty: bool = True,
                 encode_window_fn: Callable | None = None,
                 body_window_fn: Callable | None = None,
                 warm_body_window_fn: Callable | None = None, data_group=None):
        self.window_fn = window_fn
        self.data_group = data_group
        self.warm_window_fn = warm_window_fn
        self.kernel_size = kernel_size
        self.device = torch.device(device)
        self.align_windows = align_windows
        self.fast_mode = fast_mode
        self.batch_windows = max(1, batch_windows)
        self.fetch_uncertainty = fetch_uncertainty
        self.encode_window_fn = encode_window_fn
        self.body_window_fn = body_window_fn
        self.warm_body_window_fn = warm_body_window_fn
        self.encoder_cache = (
            encode_window_fn is not None and body_window_fn is not None
            and not fast_mode and self.batch_windows == 1
            and (warm_window_fn is None or warm_body_window_fn is not None))

    @property
    def output_names(self) -> tuple[str, ...]:
        return ("disparity", "uncertainties") if self.fetch_uncertainty else ("disparity",)

    def _finish(self, padder: InputPadder, outs, batched: bool = False):
        """The fetched outputs, unpadded; the window axis dropped unless
        the windows were batched."""
        outs = tuple(outs)[:len(self.output_names)]
        return tuple(padder.unpad(o if batched else o[0]) for o in outs)

    @torch.no_grad()
    def _run_window(self, left: torch.Tensor, right: torch.Tensor):
        """left/right (T, H, W, 3) -> tuple of (T, H, W, 1) outputs."""
        padder = InputPadder(left.shape[1], left.shape[2])
        lp, rp = padder.pad(left, right)
        return self._finish(padder, self.window_fn(lp[None], rp[None]))

    @torch.no_grad()
    def _run_window_warm(self, left, right, prev_disp, overlap: int):
        """A warm window seeded from the previous window's signed disparity
        (T', H, W, 1), which stays on the device."""
        padder = InputPadder(left.shape[1], left.shape[2])
        lp, rp = padder.pad(left, right)
        (fip,) = padder.pad(_warm_seed(prev_disp, left.shape[0], overlap).float())
        return self._finish(padder, self.warm_window_fn(lp[None], rp[None], fip[None]))

    def _encode(self, lp, rp, cached, n_ov: int) -> dict:
        """Features of the window's frames: the first n_ov from the cache,
        the rest from the encoders (which are per-frame, so the result is
        the same as encoding every frame)."""
        if n_ov == lp.shape[0]:  # a tail window inside the last one
            return cached
        return _concat_feats(cached, self.encode_window_fn(lp[n_ov:][None], rp[n_ov:][None]))

    @torch.no_grad()
    def _run_window_cached(self, left, right, cached, n_ov: int, keep_last: int):
        """A strict window whose first n_ov frames' features come from the
        cache; returns its outputs and the features of its last keep_last
        frames for the next window."""
        t = left.shape[0]
        padder = InputPadder(left.shape[1], left.shape[2])
        lp, rp = padder.pad(left, right)
        feats = self._encode(lp, rp, cached, n_ov)
        outs = self._finish(padder, self.body_window_fn(lp[None], rp[None], feats))
        return outs + ({k: v[:, t - keep_last:] for k, v in feats.items()},)

    @torch.no_grad()
    def _run_window_warm_cached(self, left, right, prev_disp, overlap: int, cached,
                                n_ov: int, keep_last: int):
        """A warm window with both chains: the warm seed and the features."""
        t = left.shape[0]
        padder = InputPadder(left.shape[1], left.shape[2])
        lp, rp = padder.pad(left, right)
        (fip,) = padder.pad(_warm_seed(prev_disp, t, overlap).float())
        feats = self._encode(lp, rp, cached, n_ov)
        outs = self._finish(padder, self.warm_body_window_fn(lp[None], rp[None], fip[None], feats))
        return outs + ({k: v[:, t - keep_last:] for k, v in feats.items()},)

    @torch.no_grad()
    def _run_window_batch(self, lefts: torch.Tensor, rights: torch.Tensor):
        """lefts/rights (B, T, H, W, 3) -> tuple of (B, T, H, W, 1) outputs.
        Over a data axis each rank runs its block of the B windows."""
        padder = InputPadder(lefts.shape[2], lefts.shape[3])
        group = self.data_group
        if group is not None:
            mine = local_slice(lefts.shape[0], dist.get_rank(group), dist.get_world_size(group))
            lefts, rights = lefts[mine], rights[mine]
        lp, rp = padder.pad(lefts, rights)
        outs = self._finish(padder, self.window_fn(lp, rp), batched=True)
        if group is not None:
            outs = tuple(all_gather(o.contiguous(), group, dim=0) for o in outs)
        return outs

    def _windows(self, num_ims: int, stride: int) -> list[tuple[int, int]]:
        """(start, length) of every window; the reference skips tails
        shorter than a stride (except in fast mode)."""
        k = self.kernel_size
        jobs = []
        for i in range(0, num_ims, stride):
            wlen = min(i + k, num_ims) - i
            if self.fast_mode or i == 0 or wlen >= stride:
                jobs.append((i, wlen))
        return jobs

    @torch.no_grad()
    def __call__(self, stereo_video) -> dict[str, np.ndarray]:
        """stereo_video: (N, 2, H, W, 3) in [0, 255] (numpy or tensor).

        Returns {"disparity": (N, H, W, 1)[, "uncertainties": like it]} as
        f32 numpy, disparity as absolute values."""
        video = torch.as_tensor(np.asarray(stereo_video), dtype=torch.float32)
        video = video.to(self.device)  # uploaded once; windows are slices of it
        num_ims = video.shape[0]
        k = self.kernel_size
        stride = k if self.fast_mode else k // 2

        if k > num_ims:
            outs = self._run_window(video[:, 0], video[:, 1])
            return {nm: np.abs(o.float().cpu().numpy()) for nm, o in zip(self.output_names, outs)}

        def bounds(i: int, wlen: int) -> tuple[int, int]:
            return window_trim_bounds(i, wlen, k, stride, self.fast_mode)

        kept = []  # (start, outputs on the host): trimmed unless aligning

        def keep(i: int, wlen: int, outs) -> None:
            lo, hi = (0, 0) if self.align_windows else bounds(i, wlen)
            kept.append((i, [o[lo: o.shape[0] - hi].float().cpu().numpy() for o in outs]))

        jobs = self._windows(num_ims, stride)
        frames = [(video[i:i + wlen, 0], video[i:i + wlen, 1]) for i, wlen in jobs]
        if self.warm_window_fn is not None or self.encoder_cache:
            # one window at a time, each chained to the last on the device
            prev_start = prev_disp = cache = None
            n_ov = 0
            for idx, ((i, wlen), (lw, rw)) in enumerate(zip(jobs, frames)):
                keep_last = (max(0, i + wlen - jobs[idx + 1][0])
                             if self.encoder_cache and idx + 1 < len(jobs) else 0)
                ov = 0 if prev_disp is None else max(
                    0, min(prev_start + prev_disp.shape[0] - i, wlen))
                warm = self.warm_window_fn is not None and prev_disp is not None
                if self.encoder_cache and warm:
                    *outs, cache = self._run_window_warm_cached(lw, rw, prev_disp, ov, cache,
                                                                n_ov, keep_last)
                elif self.encoder_cache:
                    *outs, cache = self._run_window_cached(lw, rw, cache, n_ov, keep_last)
                elif warm:
                    outs = self._run_window_warm(lw, rw, prev_disp, ov)
                else:
                    outs = self._run_window(lw, rw)
                n_ov = keep_last
                prev_start, prev_disp = i, outs[0]
                keep(i, wlen, outs)
        else:
            idx = 0
            while idx < len(jobs):
                n = 1  # windows of one length batch together, in order
                while (n < self.batch_windows and idx + n < len(jobs)
                       and jobs[idx + n][1] == jobs[idx][1]):
                    n += 1
                if n == 1:
                    keep(*jobs[idx], self._run_window(*frames[idx]))
                else:
                    group = range(idx, idx + n)
                    bouts = self._run_window_batch(
                        torch.stack([frames[g][0] for g in group]),
                        torch.stack([frames[g][1] for g in group]))
                    for gi, g in enumerate(group):
                        keep(*jobs[g], [o[gi] for o in bouts])
                idx += n

        parts = [[] for _ in self.output_names]
        prev_disp = prev_start = None
        for (i, outs), (_, wlen) in zip(kept, jobs):
            if self.align_windows:
                # regress on the full overlapping windows, then trim
                if prev_disp is not None:
                    ov = prev_start + len(prev_disp) - i
                    if ov > 0:
                        a, b = scale_shift_align(prev_disp[-ov:], outs[0][:ov])
                        outs[0] = a * outs[0] + b
                prev_disp, prev_start = outs[0], i
                lo, hi = bounds(i, wlen)
                outs = [o[lo: len(o) - hi] for o in outs]
            for dst, o in zip(parts, outs):
                dst.append(o)
        return {nm: np.abs(np.concatenate(plist).astype(np.float32))
                for nm, plist in zip(self.output_names, parts)}
