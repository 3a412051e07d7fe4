"""Model zoo entry point and inference wrapper (counterpart of
ppmstereo_tpu/models/zoo.py; this slice has PPMStereoModel only).

    predictor = model_zoo("PPMStereoModel", kernel_size=10, iters=10,
                          params=load_npz("checkpoints/anchor_r5.npz"))
    out = predictor({"stereo_video": video})  # (N, 2, H, W, 3) in [0, 255]
    out["disparity"]                           # (N, H, W, 1), |disparity|
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ppmstereo_tpu_torch.models.inference import SlidingWindowPredictor
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo
from ppmstereo_tpu_torch.utils.device import resolve_device, set_precision
from ppmstereo_tpu_torch.utils.weights import load_flax_params


class StereoVideoPredictor:
    """A test-mode model on its device behind the sliding-window predictor:
    predictor({"stereo_video": video}) -> {"disparity", "uncertainties"}."""

    def __init__(self, model: torch.nn.Module, kernel_size: int, device: torch.device):
        self.model = model.to(device).eval()
        self.predictor = SlidingWindowPredictor(self.model, kernel_size=kernel_size,
                                                device=device)

    def __call__(self, batch: dict) -> dict:
        return self.predictor(batch["stereo_video"])


def model_zoo(model_name: str, *, params: Mapping[str, np.ndarray],
              kernel_size: int = 20, iters: int = 20,
              mixed_precision: bool = True,
              device: str | torch.device | None = None, mesh=None):
    """Build a ready-to-run predictor by name, with the JAX package's flat
    parameters (`{"params/a/b/kernel": array}`, e.g. `load_npz` of
    checkpoints/anchor_r5.npz), at the shipped configuration in bf16, or f32
    with `mixed_precision=False`. Runs on `cuda` unless `device` names
    another device; raises when there is no card and no CPU request.

    mesh (`parallel/mesh.make_mesh`): with a `space` axis of n > 1, every
    process of the mesh calls the predictor on the same video; the play
    steps run as the ring over the processes, and every process returns
    the whole stitched video."""
    if model_name != "PPMStereoModel":
        raise ValueError(f"unknown model {model_name!r}; available: ['PPMStereoModel']")
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    model = PPMStereo(iters, mixed_precision, test_mode=True, mesh=mesh)
    load_flax_params(model, params)
    return StereoVideoPredictor(model, kernel_size, dev)
