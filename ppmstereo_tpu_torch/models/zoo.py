"""Model registry and inference wrapper (counterpart of
ppmstereo_tpu/models/zoo.py; PPMStereoModel is the one model registered).

    predictor = model_zoo("PPMStereoModel", kernel_size=10, iters=10,
                          params=load_npz("checkpoints/anchor_r5.npz"))
    out = predictor({"stereo_video": video})  # (N, 2, H, W, 3) in [0, 255]
    out["disparity"]                           # (N, H, W, 1), |disparity|

The window modes of `models/inference.py` are keyword arguments:
`fast_mode`, `batch_windows`, `warm_start` (with `warm_iters`) and
`encoder_cache`.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from ppmstereo_tpu_torch.models.inference import SlidingWindowPredictor
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.utils.device import resolve_device, set_precision
from ppmstereo_tpu_torch.utils.init import init_ppmstereo
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
    the registered constructor (see `_build_ppm`)."""
    if model_name not in _REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; available: {available_models()}")
    return _REGISTRY[model_name](**kwargs)


class StereoVideoPredictor:
    """A test-mode model on its device behind the sliding-window predictor:
    predictor({"stereo_video": video}) -> {"disparity", "uncertainties"}.

    warm_start: every window after the first is seeded with the previous
    window's disparity and runs the 1/4 stage only, `warm_iters` iterations
    (default: the model's), with the same parameters (non-parity).
    encoder_cache: overlapping windows reuse the shared frames' encoder
    features (strict). fast_mode and batch_windows: see SlidingWindowPredictor.

    Every window's encoders run on gcd(kernel_size, kernel_size // 2)
    frames a call (`encode_frames(frames_per_call=)`): window starts and the
    cache's first new frame fall on multiples of it, so a frame is encoded
    in the same call in every window and mode, and the cached features are
    the bits a strict window computes (a convolution library may pick
    another algorithm for another batch size). Where that gcd is 1 (an odd
    kernel_size) a window encodes its frames in one call instead: one frame
    a call cost a strict 320x512 window of 9 frames 15.6 % on an H100
    (tools/window_bits.py), so there the cache is not bit-equal to strict."""

    def __init__(self, model: PPMStereo, kernel_size: int, device: torch.device,
                 fast_mode: bool = False, batch_windows: int = 1, warm_start: bool = False,
                 warm_iters: int | None = None, encoder_cache: bool = False):
        self.model = model = model.to(device).eval()
        chunk = math.gcd(kernel_size, kernel_size // 2)
        chunk = chunk if chunk > 1 else None

        def encode(left, right):
            return model.encode_frames(left, right, frames_per_call=chunk)

        def window_fn(left, right):
            return model(left, right, feats=encode(left, right))

        warm_fn = enc_fn = body_fn = warm_body_fn = None
        if warm_start:
            def warm_fn(left, right, flow_init):
                return model(left, right, flow_init=flow_init, feats=encode(left, right),
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
            body_window_fn=body_fn, warm_body_window_fn=warm_body_fn)

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

    mesh (`parallel/mesh.make_mesh`): with a `space` axis of n > 1, every
    process of the mesh calls the predictor on the same video; the play
    steps run as the ring over the processes, and every process returns
    the whole stitched video."""
    cfg = PPMStereoConfig(**cfg_kwargs)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    model = PPMStereo(cfg, iters, test_mode=True, mesh=mesh)
    if params is None:
        init_ppmstereo(model, seed)
    else:
        load_flax_params(model, params)
    return StereoVideoPredictor(model, kernel_size, dev, fast_mode=fast_mode,
                                batch_windows=batch_windows, warm_start=warm_start,
                                warm_iters=warm_iters, encoder_cache=encoder_cache)
