"""Helpers of the baselines' parity tests (tests/test_torch_dynamic_stereo.py,
test_torch_raft.py, test_torch_raft_stereo.py, test_torch_bidastereo.py,
test_torch_import.py): the JAX package's `jax.jit(init)` parameters as a
writable numpy tree (or the port's own initialisation as such a tree,
`port_init_tree`), with the leaves that start at zero drawn, and the port's
module with those parameters carried across.

The JAX models' initialisers set some leaves to zero (the SST time
embedding, the temporal attention's output projection `temporal_fc`); with
them at zero the time embedding and the temporal attention would not reach
the output, so `draw_zero_leaves` draws them from a normal of std 0.1
before the comparison.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppmstereo_tpu_torch.utils.init import init_model
from ppmstereo_tpu_torch.utils.weights import (
    flatten_params,
    load_flax_params,
    state_dict_to_flax,
    transposed_kernels,
)
from tests.torch_parity_data import synthetic_clip

DISP_TOL = 1e-4  # px, as tests/test_torch_model.py


def jax_init(module, *inputs, seed: int = 0, method=None) -> dict:
    """`jax.jit(module.init)` on numpy inputs -> a writable numpy tree
    {"params": ...} (and any other collection)."""
    args = [jnp.asarray(x) for x in inputs]
    init = jax.jit(lambda key, *a: module.init(key, *a, method=method))
    tree = init(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(lambda x: np.array(x, dtype=np.float32), tree)


def port_init_tree(module: torch.nn.Module, seed: int = 0) -> dict:
    """The port's `init_model(seed)` of `module` (the JAX initializers'
    distributions, utils/init.py) as a writable {"params": ...} numpy tree
    for the JAX module: a `jax.jit(init)` would compile the JAX model's
    forward once more (30-100 s here) for parameters of the same
    distributions."""
    init_model(module, seed)
    tree: dict = {}
    for path, v in state_dict_to_flax(module.state_dict(), transposed_kernels(module)).items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def variable_shapes(tree: Mapping, prefix: str = "") -> dict:
    """A nested variable tree -> {"params/a/b/leaf": shape}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out.update(variable_shapes(val, path) if isinstance(val, Mapping)
                   else {path: tuple(val.shape)})
    return out


def checked_port_init(jax_module, port_module: torch.nn.Module, *inputs, seed: int = 0) -> dict:
    """`port_init_tree(port_module, seed)`, whose variables (every
    collection, name by name and shape by shape) must be the JAX module's:
    `jax.eval_shape` of its init traces it without compiling it (~5 s on a
    CPU for a whole model, where a `jax.jit(init)` compiles the forward
    once more)."""
    want = variable_shapes(jax.eval_shape(jax_module.init, jax.random.PRNGKey(seed),
                                          *[jnp.asarray(x) for x in inputs]))
    tree = port_init_tree(port_module, seed)
    got = variable_shapes(tree)
    assert got == want, (sorted(set(got) ^ set(want)),
                         {k: (got[k], want[k]) for k in set(got) & set(want) if got[k] != want[k]})
    return tree


def draw_zero_leaves(tree: dict, seed: int = 0, std: float = 0.1) -> dict:
    """Draw every `time_embed` and `temporal_fc` leaf (zero at init) in place."""
    rng = np.random.default_rng(seed)

    def visit(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                visit(val, path + (key,))
            elif key == "time_embed" or "temporal_fc" in path:
                node[key] = rng.normal(0, std, val.shape).astype(np.float32)

    visit(tree, ())
    return tree


def carried(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """The port's module with the JAX tree's parameters (strict), in eval
    mode."""
    load_flax_params(module, flatten_params(tree))
    return module.eval()


def jax_apply(module, tree: dict, *inputs, method=None, **kwargs):
    """`jax.jit(module.apply)` on numpy inputs -> numpy output(s)."""
    args = [jnp.asarray(x) for x in inputs]
    out = jax.jit(lambda p, *a: module.apply(p, *a, method=method, **kwargs))(tree, *args)
    return jax.tree_util.tree_map(np.asarray, out)


def port_apply(module, *inputs, **kwargs):
    """The port's module under no_grad on numpy inputs -> numpy output(s)."""
    with torch.no_grad():
        out = module(*[torch.from_numpy(np.ascontiguousarray(x)) for x in inputs], **kwargs)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def stereo_clip(frames: int, h: int, w: int, seed: int = 0):
    """(left, right) (1, frames, h, w, 3) float32 in [0, 255] and the clip
    (frames, 2, h, w, 3)."""
    video, _ = synthetic_clip(frames, h, w, seed=seed)
    return video[None, :, 0], video[None, :, 1], video


def max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
