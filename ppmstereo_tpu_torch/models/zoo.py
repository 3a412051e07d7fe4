"""Model registry and inference wrapper (counterpart of
ppmstereo_tpu/models/zoo.py). Registered: PPMStereoModel, PPMStereoVDAModel
and the baselines DynamicStereoModel, RAFTStereoModel, BiDAStereoModel and
StereoAnyVideoModel.

    predictor = model_zoo("PPMStereoModel", kernel_size=10, iters=10,
                          params=load_npz("checkpoints/anchor_r5.npz"))
    out = predictor({"stereo_video": video})  # (N, 2, H, W, 3) in [0, 255]
    out["disparity"]                           # (N, H, W, 1), |disparity|
    out["uncertainties"]                       # PPMStereoModel only

The window modes of `models/inference.py` are keyword arguments:
`fast_mode` and `batch_windows` for every model, `warm_start` (with
`warm_iters`) and `encoder_cache` for PPMStereoModel.

`mesh` (`parallel/mesh.make_mesh`, every process of it calling the
predictor on the same video): over its `data` axis the windows of a
`batch_windows` batch spread over the processes, for every model; the
`seq` axis spreads each of PPMStereoModel's windows' frames, and the
`space` axis rings its play steps. `seq` and `space` for the other models
raise (ROADMAP §1 item 7.1b).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ppmstereo_tpu_torch.models.bidastereo import BiDAStereo, BiDAStereoConfig
from ppmstereo_tpu_torch.models.dynamic_stereo import DynamicStereo, DynamicStereoConfig
from ppmstereo_tpu_torch.models.inference import SlidingWindowPredictor
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.models.raft_stereo import RAFTStereoConfig, RAFTStereoVideoAdapter
from ppmstereo_tpu_torch.models.stereoanyvideo import StereoAnyVideo, StereoAnyVideoConfig
from ppmstereo_tpu_torch.utils.device import resolve_device, set_precision
from ppmstereo_tpu_torch.utils.init import init_model
from ppmstereo_tpu_torch.utils.weights import load_flax_params

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def model_zoo(model_name: str, **kwargs):
    """Build a ready-to-run predictor by name; the keyword arguments go to
    the registered constructor (see `_build_ppm` and `_build_baseline`)."""
    if model_name not in _REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; available: {available_models()}")
    return _REGISTRY[model_name](**kwargs)


class StereoVideoPredictor:
    """A test-mode model on its device behind the sliding-window predictor:
    predictor({"stereo_video": video}) -> {"disparity"[, "uncertainties"]}.
    The model maps (left, right) windows (B, T, H, W, 3) to the disparity,
    or to (disparity, uncertainty); `outputs_uncertainty=False` drops the
    uncertainty from the output, as the JAX wrapper does for the baselines.

    warm_start: every window after the first is seeded with the previous
    window's disparity and runs the 1/4 stage only, `warm_iters` iterations
    (default: the model's), with the same parameters (non-parity).
    encoder_cache: overlapping windows reuse the shared frames' encoder
    features (strict). Both need PPMStereo's `encode_frames` and
    `forward(flow_init=, feats=, warm_iters=)`; for another model they raise
    (the JAX package's wrapper cannot run them for the baselines either).
    fast_mode and batch_windows: see SlidingWindowPredictor.

    A model with `encode_frames` runs every window's encoders on
    gcd(kernel_size, kernel_size // 2) frames a call
    (`encode_frames(frames_per_call=)`): window starts and the
    cache's first new frame fall on multiples of it, so a frame is encoded
    in the same call in every window and mode, and the cached features are
    the bits a strict window computes (a convolution library may pick
    another algorithm for another batch size). Where that gcd is 1 (an odd
    kernel_size) a window encodes its frames in one call instead: one frame
    a call cost a strict 320x512 window of 9 frames 15.6 % on an H100
    (tools/window_bits.py), so there the cache is not bit-equal to strict.
    A model without per-frame encoders (the baselines, and PPMStereo with
    `use_vfm`, whose backbone attends over the window's frames) runs whole
    windows."""

    def __init__(self, model: nn.Module, kernel_size: int, device: torch.device,
                 fast_mode: bool = False, batch_windows: int = 1, warm_start: bool = False,
                 warm_iters: int | None = None, encoder_cache: bool = False,
                 outputs_uncertainty: bool = True, data_group=None):
        self.model = model = model.to(device).eval()
        if not hasattr(model, "encode_frames") or model.cfg.use_vfm:
            if warm_start or encoder_cache:
                name = type(model).__name__
                name += " with use_vfm" if hasattr(model, "encode_frames") else ""
                raise ValueError(
                    "warm_start and encoder_cache need PPMStereo's encode_frames and "
                    f"forward(flow_init=, feats=); {name} has neither (the JAX package's "
                    "wrapper cannot run them for this model either)")

            def whole_window_fn(left, right):
                out = model(left, right)
                return out if isinstance(out, tuple) else (out,)

            self.predictor = SlidingWindowPredictor(
                whole_window_fn, kernel_size=kernel_size, device=device, fast_mode=fast_mode,
                batch_windows=batch_windows, fetch_uncertainty=outputs_uncertainty,
                data_group=data_group)
            return
        chunk = math.gcd(kernel_size, kernel_size // 2)
        chunk = chunk if chunk > 1 else None

        def encode(left, right):
            return model.encode_frames(left, right, frames_per_call=chunk)

        # the model encodes the window's frames itself (under a seq mesh
        # only this process's frames), in calls of `chunk` frames
        def window_fn(left, right):
            return model(left, right, frames_per_call=chunk)

        warm_fn = enc_fn = body_fn = warm_body_fn = None
        if warm_start:
            def warm_fn(left, right, flow_init):
                return model(left, right, flow_init=flow_init, frames_per_call=chunk,
                             warm_iters=warm_iters)
        if encoder_cache:
            enc_fn = encode

            def body_fn(left, right, feats):
                return model(left, right, feats=feats)

            if warm_start:
                def warm_body_fn(left, right, flow_init, feats):
                    return model(left, right, flow_init=flow_init, feats=feats,
                                 warm_iters=warm_iters)
        self.predictor = SlidingWindowPredictor(
            window_fn, kernel_size=kernel_size, device=device, fast_mode=fast_mode,
            batch_windows=batch_windows, warm_window_fn=warm_fn, encode_window_fn=enc_fn,
            body_window_fn=body_fn, warm_body_window_fn=warm_body_fn,
            fetch_uncertainty=outputs_uncertainty, data_group=data_group)

    def load_params(self, params: Mapping[str, np.ndarray]) -> None:
        """Load flat flax parameters (`{"params/a/b/kernel": array}`)."""
        load_flax_params(self.model, params)

    def __call__(self, batch: dict) -> dict:
        return self.predictor(batch["stereo_video"])


@register("PPMStereoModel")
def _build_ppm(kernel_size: int = 20, iters: int = 20,
               params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
               device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
               batch_windows: int = 1, warm_start: bool = False,
               warm_iters: int | None = None, encoder_cache: bool = False,
               **cfg_kwargs) -> StereoVideoPredictor:
    """PPMStereo at `PPMStereoConfig(**cfg_kwargs)` (the shipped
    configuration in bf16 by default; `mixed_precision=False` for f32, any
    other field of the config by name), with the JAX package's flat
    parameters (`load_npz` of checkpoints/anchor_r5.npz), or, with
    `params=None`, the port's own initialisation from `seed`. Runs on
    `cuda` unless `device` names another device; raises when there is no
    card and no CPU request.

    mesh (`parallel/mesh.make_mesh`): every process of the mesh calls the
    predictor on the same video and returns the whole stitched video. With
    a `space` axis of n > 1 the play steps run as the ring over it; with a
    `data` axis of n > 1 a batch of `batch_windows` windows spreads over it
    (the model's batch mean of the picked scores is the whole batch's);
    with a `seq` axis of S > 1 each window's frames spread over it, in
    every window mode, a window whose length S does not divide running
    whole on every process of the axis."""
    cfg = PPMStereoConfig(**cfg_kwargs)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    model = PPMStereo(cfg, iters, test_mode=True, mesh=mesh)
    _load_or_init(model, params, seed)
    return StereoVideoPredictor(model, kernel_size, dev, fast_mode=fast_mode,
                                batch_windows=batch_windows, warm_start=warm_start,
                                warm_iters=warm_iters, encoder_cache=encoder_cache,
                                data_group=_data_group(mesh))


@register("PPMStereoVDAModel")
def _build_ppm_vda(kernel_size: int = 20, iters: int = 20,
                   params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
                   device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
                   batch_windows: int = 1, warm_start: bool = False,
                   warm_iters: int | None = None, encoder_cache: bool = False,
                   **cfg_kwargs) -> StereoVideoPredictor:
    """PPMStereo-VDA: `PPMStereoConfig(use_vfm=True, use_cnet=True,
    **cfg_kwargs)` (bf16 and the ViT-S backbone by default), in test mode;
    the other arguments as for PPMStereoModel. It has no per-frame encoders,
    so warm_start and encoder_cache raise, as the JAX package's constructor
    takes neither. A mesh's seq axis raises (ROADMAP §1 item 7.1b: the
    backbone attends across the window's frames)."""
    cfg = PPMStereoConfig(use_vfm=True, use_cnet=True, **cfg_kwargs)
    model = PPMStereo(cfg, iters, test_mode=True, mesh=mesh)
    return _build_baseline(model, kernel_size, params, seed, device, fast_mode, batch_windows,
                           warm_start or warm_iters is not None, encoder_cache,
                           outputs_uncertainty=True, mesh=mesh)


def _data_group(mesh, model_name: str | None = None):
    """The data axis's process group of `mesh` (None without one). For a
    model other than PPMStereo (`model_name`) a seq or space axis raises."""
    if mesh is None:
        return None
    if model_name is not None and (mesh.shape["seq"] > 1 or mesh.shape["space"] > 1):
        raise NotImplementedError(
            f"mesh {mesh.shape}: {model_name} spreads windows over the data axis only; the "
            "space ring and the seq axis are PPMStereoModel's, and the rest of the zoo's are "
            "ROADMAP §1 item 7.1b")
    return mesh.groups["data"]


def _load_or_init(model: nn.Module, params, seed: int) -> None:
    if params is None:
        init_model(model, seed)
    else:
        load_flax_params(model, params)


def _build_baseline(model: nn.Module, kernel_size: int, params, seed: int, device,
                    fast_mode: bool, batch_windows: int, warm: bool,
                    encoder_cache: bool, outputs_uncertainty: bool = False, mesh=None
                    ) -> StereoVideoPredictor:
    """A whole-window model with the JAX package's flat parameters
    (`params`: its init's, or the npz of an import CLI) or, with
    `params=None`, the port's initialisation from `seed`; on `cuda` unless
    `device` names another device. The output has no uncertainty unless
    `outputs_uncertainty`; a warm start (`warm`) and encoder_cache raise
    (see StereoVideoPredictor). `mesh`: its data axis (see model_zoo)."""
    group = _data_group(mesh, type(model).__name__)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    _load_or_init(model, params, seed)
    return StereoVideoPredictor(model, kernel_size, dev, fast_mode=fast_mode,
                                batch_windows=batch_windows, warm_start=warm,
                                encoder_cache=encoder_cache,
                                outputs_uncertainty=outputs_uncertainty, data_group=group)


@register("DynamicStereoModel")
def _build_dynamic(kernel_size: int = 20, iters: int = 20,
                   params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
                   device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
                   batch_windows: int = 1, warm_start: bool = False,
                   warm_iters: int | None = None, encoder_cache: bool = False,
                   **cfg_kwargs) -> StereoVideoPredictor:
    """DynamicStereo at `DynamicStereoConfig(**cfg_kwargs)` (the shipped
    configuration in bf16 by default), in test mode; the other arguments as
    for PPMStereoModel (`_build_baseline`)."""
    model = DynamicStereo(DynamicStereoConfig(**cfg_kwargs), iters, test_mode=True)
    return _build_baseline(model, kernel_size, params, seed, device, fast_mode, batch_windows,
                           warm_start or warm_iters is not None, encoder_cache, mesh=mesh)


@register("RAFTStereoModel")
def _build_raft_stereo(kernel_size: int = 20, iters: int = 32,
                       params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
                       device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
                       batch_windows: int = 1, warm_start: bool = False,
                       warm_iters: int | None = None, encoder_cache: bool = False,
                       **cfg_kwargs) -> StereoVideoPredictor:
    """RAFT-Stereo at `RAFTStereoConfig(**cfg_kwargs)` (f32 by default, as
    shipped) on each frame pair of a window (`RAFTStereoVideoAdapter`); the
    other arguments as for PPMStereoModel (`_build_baseline`)."""
    model = RAFTStereoVideoAdapter(RAFTStereoConfig(**cfg_kwargs), iters)
    return _build_baseline(model, kernel_size, params, seed, device, fast_mode, batch_windows,
                           warm_start or warm_iters is not None, encoder_cache, mesh=mesh)


@register("BiDAStereoModel")
def _build_bida(kernel_size: int = 20, iters: int = 10,
                params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
                device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
                batch_windows: int = 1, warm_start: bool = False,
                warm_iters: int | None = None, encoder_cache: bool = False,
                **cfg_kwargs) -> StereoVideoPredictor:
    """BiDAStereo with its frozen RAFT at `BiDAStereoConfig(**cfg_kwargs)`
    (f32 by default), in test mode; the other arguments as for
    PPMStereoModel (`_build_baseline`)."""
    model = BiDAStereo(BiDAStereoConfig(**cfg_kwargs), iters, test_mode=True)
    return _build_baseline(model, kernel_size, params, seed, device, fast_mode, batch_windows,
                           warm_start or warm_iters is not None, encoder_cache, mesh=mesh)


@register("StereoAnyVideoModel")
def _build_sav(kernel_size: int = 20, iters: int = 12,
               params: Mapping[str, np.ndarray] | None = None, seed: int = 0,
               device: str | torch.device | None = None, mesh=None, fast_mode: bool = False,
               batch_windows: int = 1, warm_start: bool = False,
               warm_iters: int | None = None, encoder_cache: bool = False,
               **cfg_kwargs) -> StereoVideoPredictor:
    """StereoAnyVideo at `StereoAnyVideoConfig(**cfg_kwargs)` (f32 and the
    ViT-S backbone by default, as shipped), in test mode, under cuDNN's
    benchmark mode in f32; the other arguments as for PPMStereoModel
    (`_build_baseline`)."""
    model = StereoAnyVideo(StereoAnyVideoConfig(**cfg_kwargs), iters, test_mode=True)
    return _build_baseline(model, kernel_size, params, seed, device, fast_mode, batch_windows,
                           warm_start or warm_iters is not None, encoder_cache, mesh=mesh)
