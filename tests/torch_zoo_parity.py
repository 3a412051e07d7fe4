"""Helpers of the baselines' parity tests (tests/test_torch_dynamic_stereo.py,
test_torch_raft.py, test_torch_raft_stereo.py, test_torch_bidastereo.py,
test_torch_import.py): the JAX package's `jax.jit(init)` parameters as a
writable numpy tree, with the leaves that start at zero drawn, and the
port's module with those parameters carried across.

The JAX models' initialisers set some leaves to zero (the SST time
embedding, the temporal attention's output projection `temporal_fc`); with
them at zero the time embedding and the temporal attention would not reach
the output, so `draw_zero_leaves` draws them from a normal of std 0.1
before the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppmstereo_tpu_torch.utils.weights import flatten_params, load_flax_params
from tests.torch_parity_data import synthetic_clip

DISP_TOL = 1e-4  # px, as tests/test_torch_model.py


def jax_init(module, *inputs, seed: int = 0, method=None) -> dict:
    """`jax.jit(module.init)` on numpy inputs -> a writable numpy tree
    {"params": ...} (and any other collection)."""
    args = [jnp.asarray(x) for x in inputs]
    init = jax.jit(lambda key, *a: module.init(key, *a, method=method))
    tree = init(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(lambda x: np.array(x, dtype=np.float32), tree)


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
