"""The parity runs of `PPMStereoConfig`'s switches, shared by
tests/test_torch_config_*.py: one configuration through the JAX package's
`PPMStereo` and the port's, with the JAX package's parameters carried
across, on one seeded synthetic clip, in f32.

The parameters are the port's initialisation (`port_params`; with
`checked_port_params` its parameter set checked, name by name and shape by
shape, against the JAX model's, which `jax.eval_shape` of the JAX init
gives without compiling the model), with every play blend `beta` set to 1
and the SST time embedding drawn from a normal of std 0.5: at
initialisation both are zero, and the play step and the time embedding
would not reach the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JConfig
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.utils.weights import flatten_params, load_flax_params
from tests.torch_parity_data import synthetic_clip
from tests.torch_zoo_parity import port_init_tree, variable_shapes

# tests/test_torch_model.py's limits (its docstring gives the measurements
# they rest on): the play step rounds q/k/v to bf16 in both packages, so an
# f32 difference in the last bit of q can move the play output by 2^-8
DISP_TOL = 1e-4
UNC_TOL = 3e-6

# the JAX package's multi-device configuration (tests/distributed_common.py);
# top_k is the clip's length
CONFIG_A = {"use_cnet": False, "attention_type": None}
CONFIG_B = {"use_convex_3d": False, "corr_levels": 3, "corr_radius": 3, "sst_depth": 2}
# widths: a GRU state of 64 and features of 192 (the context input stays
# dim - hidden_dim = 128, which the first stage's 384-wide update attention
# needs; the play's head dim, context_dim, is 128 in every configuration the
# JAX model runs, see `PPMStereoConfig`)
CONFIG_C = {"hidden_dim": 64, "dim": 192}


def clip(frames: int, h: int, w: int, seed: int = 0):
    """(left, right) (1, frames, h, w, 3) float32 in [0, 255]."""
    video, _ = synthetic_clip(frames, h, w, seed=seed)
    return video[None, :, 0], video[None, :, 1]


def checked_port_params(cfg_kwargs: dict, left, right, iters: int, seed: int = 0) -> dict:
    """`port_params` of the configuration, whose parameter set must be the
    JAX model's (the names and shapes of `jax.eval_shape` of its init: a
    trace, where a `jax.jit(init)` would also compile the forward, 15-60 s
    on a CPU, for values that the parity does not depend on)."""
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True,
                                num_frames=left.shape[1], **cfg_kwargs),
                    iters=iters, test_mode=True)
    want = variable_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(seed), jnp.asarray(left),
                                          jnp.asarray(right)))
    tree = port_params(cfg_kwargs, left.shape[1], iters, seed)
    got = variable_shapes(tree)
    assert got == want, (sorted(set(got) ^ set(want)),
                         {k: (got[k], want[k]) for k in set(got) & set(want) if got[k] != want[k]})
    return tree


def port_params(cfg_kwargs: dict, frames: int, iters: int, seed: int = 0) -> dict:
    """The port's initialisation of the configuration
    (tests/torch_zoo_parity.py::port_init_tree), with every `beta` 1 and
    the time embedding drawn."""
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False, num_frames=frames,
                                                **cfg_kwargs), iters=iters, test_mode=True)
    return reach_the_output(port_init_tree(model, seed), seed)


def reach_the_output(tree: dict, seed: int) -> dict:
    """Every play blend `beta` 1 and the SST time embedding drawn (see the
    module docstring), in place."""
    rng = np.random.default_rng(seed)
    for name in ("update_block16", "update_block08", "update_block04"):
        tree["params"][name]["update_block"]["aggregator"]["beta"][:] = 1.0
    sst = tree["params"].get("sst", {})
    if "time_embed" in sst:
        sst["time_embed"] = rng.normal(0, 0.5, sst["time_embed"].shape).astype(np.float32)
    return tree


def run_jax(cfg_kwargs: dict, tree: dict, left, right, iters: int, test_mode: bool):
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True,
                                num_frames=left.shape[1], **cfg_kwargs),
                    iters=iters, test_mode=test_mode)
    out = jax.jit(jm.apply)(tree, jnp.asarray(left), jnp.asarray(right))
    return tuple(np.asarray(x) for x in out)


def port_model(cfg_kwargs: dict, tree: dict, frames: int, iters: int,
               test_mode: bool) -> tppm.PPMStereo:
    cfg = tppm.PPMStereoConfig(mixed_precision=False, num_frames=frames, **cfg_kwargs)
    model = tppm.PPMStereo(cfg, iters=iters, test_mode=test_mode)
    load_flax_params(model, flatten_params(tree))
    return model.eval()


def run_port(model, left, right, **kwargs):
    with torch.no_grad():
        out = model(torch.from_numpy(left), torch.from_numpy(right), **kwargs)
    return tuple(x.numpy() for x in out)
