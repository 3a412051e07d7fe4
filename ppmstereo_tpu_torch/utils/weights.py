"""Carry weights from the JAX package's parameter layout into the port.

The JAX package's parameters, flattened to `{"params/a/b/kernel": array}`
(the format of `checkpoints/anchor_r5.npz`), become a `state_dict` of the
port by a rename and layout transposes: the port's submodules carry the
flax path names, so `params/a/b/<leaf>` is `a.b.<leaf>` with

  kernel -> weight   Dense (in, out) -> (out, in); Conv HWIO -> OIHW and
                     DHWIO -> OIDHW; ConvTranspose (kh, kw, I, O) -> torch's
                     (I, O, kh, kw), flipped in space (flax's transposed
                     convolution applies its kernel mirrored against
                     torch's)
  scale  -> weight   LayerNorm, GroupNorm, FrozenBatchNorm
  bias, gamma (LayerScale, GRN), beta, time_embed, init_hidden_state,
  DINOv2's cls_token and pos_embed, and FrozenBatchNorm's statistics mean
  and var (buffers of the port) keep their names and layouts.

A 4-D kernel is a ConvTranspose's where the model holds an
`nn.ConvTranspose2d` at that path (`transposed_kernels`); the flat layout
alone cannot tell, since ViT-S's two transposed convolutions have as many
inputs as outputs.

`state_dict_to_flax` is the inverse: it writes the port's parameters (a
trained port model, or its gradients) in the flat flax layout, which
`export_npz` saves in the anchor's npz format for either package's
`model_zoo`.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_KERNEL_INV = {n: tuple(np.argsort(perm)) for n, perm in _KERNEL_PERM.items()}


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested {"params": {...}} mapping -> flat {"params/a/b/leaf": array}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def transposed_kernels(model: nn.Module) -> frozenset[str]:
    """The state_dict names of the model's transposed-convolution weights."""
    return frozenset(f"{name}.weight" if name else "weight"
                     for name, mod in model.named_modules()
                     if isinstance(mod, nn.ConvTranspose2d))


def transposed_to_torch(kernel: np.ndarray) -> np.ndarray:
    """A flax ConvTranspose kernel (kh, kw, I, O) as torch's ConvTranspose2d
    weight (I, O, kh, kw): flax applies the kernel mirrored in space."""
    return kernel[::-1, ::-1].transpose(2, 3, 0, 1)


def transposed_to_flax(weight: np.ndarray) -> np.ndarray:
    """The inverse of `transposed_to_torch`."""
    return weight.transpose(2, 3, 0, 1)[::-1, ::-1]


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       transposed: frozenset[str] = frozenset()) -> dict[str, torch.Tensor]:
    """Flat flax parameters -> the port's state_dict (f32 tensors);
    `transposed`: the names of transposed-convolution weights."""
    state = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        arr = np.asarray(arr, dtype=np.float32)
        name = ".".join(parts[:-1] + ["weight" if leaf in ("kernel", "scale") else leaf])
        if name in transposed:
            arr = transposed_to_torch(arr)
        elif leaf == "kernel":
            if arr.ndim not in _KERNEL_PERM:
                raise ValueError(f"{path}: unexpected kernel rank {arr.ndim}")
            arr = arr.transpose(_KERNEL_PERM[arr.ndim])
        state[name] = torch.from_numpy(np.array(arr, order="C"))
    return state


def state_dict_to_flax(state: Mapping[str, torch.Tensor],
                       transposed: frozenset[str] = frozenset()) -> dict[str, np.ndarray]:
    """The port's state_dict (or any mapping of its parameter names to
    tensors of the parameters' shapes, such as their gradients) -> flat flax
    parameters {"params/a/b/leaf": f32 array}. A 1-D `weight` is a norm's
    scale; the names in `transposed` are ConvTranspose kernels; every other
    `weight` is a Dense or Conv kernel."""
    flat = {}
    for name, tensor in state.items():
        *parents, leaf = name.split(".")
        arr = tensor.detach().float().cpu().numpy()
        if name in transposed:
            arr, leaf = transposed_to_flax(arr), "kernel"
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            if arr.ndim not in _KERNEL_INV:
                raise ValueError(f"{name}: unexpected weight rank {arr.ndim}")
            arr = arr.transpose(_KERNEL_INV[arr.ndim])
            leaf = "kernel"
        flat["/".join(["params", *parents, leaf])] = np.ascontiguousarray(arr)
    return flat


def export_npz(model: nn.Module, path: str | Path) -> None:
    """Save the model's parameters as a flat flax npz (f32), the format of
    checkpoints/anchor_r5.npz that `load_npz` and both packages read."""
    np.savez(path, **state_dict_to_flax(model.state_dict(), transposed_kernels(model)))


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load flat flax parameters into `model`; every parameter of the model
    must be given and every given parameter must exist (strict).

    A time embedding (`...time_embed`, (1, frames, C)) takes the number of
    frames of the array being loaded: a model trained on clips of another
    length loads as it is, and the SST resizes the embedding to each clip
    at apply time, as the JAX package does. The parameter is resized in
    place, so an optimiser that holds it keeps holding it."""
    state = flax_to_state_dict(flat, transposed_kernels(model))
    params = dict(model.named_parameters())
    for name, value in state.items():
        p = params.get(name)
        if name.endswith("time_embed") and p is not None and p.shape != value.shape:
            if p.shape[0] != value.shape[0] or p.shape[2:] != value.shape[2:]:
                raise ValueError(f"{name}: cannot load {tuple(value.shape)} into "
                                 f"{tuple(p.shape)}")
            p.data = torch.zeros(value.shape, dtype=p.dtype, device=p.device)
    model.load_state_dict(state, strict=True)


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Read a flat parameter file such as checkpoints/anchor_r5.npz."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
