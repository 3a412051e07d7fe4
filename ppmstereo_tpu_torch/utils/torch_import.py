"""Reference PyTorch checkpoints (state dicts) into the flax parameter
layout (counterpart of ppmstereo_tpu/utils/torch_import.py).

A reference state dict maps module names to tensors in torch layouts; the
mapping tables (`utils/ppm_mapping.py`, `utils/zoo_mappings.py`) name each
key's flax path. `import_by_mapping` writes each mapped tensor at its path,
transposed once into the flax layout:

  Conv2d weight  (O, I, kh, kw)      -> (kh, kw, I, O)
  Conv3d weight  (O, I, kt, kh, kw)  -> (kt, kh, kw, I, O)
  Linear weight  (O, I)              -> (I, O)
  ConvTranspose2d weight (I, O, kh, kw) -> (kh, kw, I, O), flipped in space
                 (`deconv2d_w`, by the table's `vda_transform`)
  norm weights, biases and statistics as they are.

The result is the flat parameter file both packages read (`cli/
import_torch.py`); `utils/weights.py` turns it into the port's state dict
with the inverse transposes.

`load_state_dict` reads a .pth with `torch.load(weights_only=True)`: a
checkpoint that needs arbitrary Python objects raises instead of running
their code (the JAX package loads with weights_only=False).
"""

from __future__ import annotations

import pickle
import re
from collections.abc import Callable, Mapping

import numpy as np
import torch


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """A .pth (torch) or .npz (numpy) state dict as numpy arrays, unwrapped
    as the reference's loader does: a `model` entry, then a `state_dict`
    entry, then the `module.` prefix of a data-parallel wrapper."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        try:
            raw = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{path}: the checkpoint holds objects other than tensors and plain "
                "containers, which torch.load(weights_only=True) refuses to unpickle; "
                "loading it with weights_only=False would run code from the file. Save the "
                "state dict alone (torch.save(model.state_dict(), path))") from e
        if "model" in raw:
            raw = raw["model"]
        if "state_dict" in raw:
            raw = raw["state_dict"]
        raw = {k: v.detach().cpu().numpy() for k, v in raw.items()}
    return {re.sub(r"^module\.", "", k): np.asarray(v) for k, v in raw.items()}


def conv2d_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def conv3d_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 4, 1, 0))


def deconv2d_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kh, kw) -> flax ConvTranspose (kh, kw, I,
    O), flipped in space: flax's transposed convolution (transpose_kernel=
    False) applies its kernel mirrored against torch's."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def convert_tensor(name: str, w: np.ndarray) -> np.ndarray:
    """A reference tensor in the flax layout, by its rank."""
    if w.ndim == 4:
        return conv2d_w(w)
    if w.ndim == 5:
        return conv3d_w(w)
    if w.ndim == 2:
        return linear_w(w)
    return w


def import_by_mapping(
    torch_sd: Mapping[str, np.ndarray],
    flat_params: Mapping[str, np.ndarray],
    mapping: Mapping[str, str],
    transform: Callable[[str, np.ndarray], np.ndarray] = convert_tensor,
) -> tuple[dict[str, np.ndarray], list[str]]:
    """Flat flax parameters {"a/b/kernel": array} with each `mapping[key] =
    "a/b/kernel"` overwritten by the state dict's tensor, transformed into
    the flax layout and cast to the parameter's dtype. Returns (the new
    parameters, the missing keys: mapped keys absent from the state dict,
    and "(flax) path" for a mapped path the parameters lack). A shape that
    differs raises."""
    flat = dict(flat_params)
    missing = []
    for tkey, fkey in mapping.items():
        if tkey not in torch_sd:
            missing.append(tkey)
            continue
        if fkey not in flat:
            missing.append(f"(flax) {fkey}")
            continue
        w = transform(tkey, torch_sd[tkey])
        if tuple(flat[fkey].shape) != tuple(w.shape):
            raise ValueError(f"shape mismatch {tkey} -> {fkey}: {w.shape} vs "
                             f"{flat[fkey].shape}")
        flat[fkey] = np.asarray(w).astype(np.asarray(flat[fkey]).dtype)
    return flat, missing
