"""Training PPMStereo-VDA (`--name ppmstereo_vda`): one port train step
against the JAX trainer's (tests/torch_train_parity.py: the loss, every
trainable gradient, the updated parameters, the frozen partition), and a
wrong play backward that must fail the gradient limit.

Weights: the port's seeded initialisation carried to the JAX model
(tests/torch_train_parity.py), with every play blend `beta` 1 and the SST
time embedding drawn (as tests/torch_config_parity.py does) and the
backbone's motion modules' `proj_out` drawn (zero at init). Input: a (1, 2,
64, 128) synthetic batch (the ConvNeXt context net needs heights of a
multiple of 32; the backbone sees 56x126), 2 iterations (1 + 1 + 2 over the
three stages). The frozen partition is the context net's ConvNeXt and the
Video-Depth-Anything backbone. Both packages round the play step's q/k/v
and probabilities to bf16 (tests/test_torch_train.py's docstring gives what
that does to the gradients).
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.utils.weights import flatten_params
from tests import torch_train_parity as tp
from tests.test_torch_vda import draw_proj_out

torch.set_num_threads(2)
FRAMES, H, W, ITERS = 2, 64, 128, 2
KWARGS = {"force_xla_attention": True}
# the gradients outside the feature encoders: where the f32 sums ahead of
# the play step part in their last bits, some of its bf16 roundings of
# q/k/v and of their gradients flip (tests/test_torch_train.py), and the
# JAX package's CPU backward carries more f32 error than the port's
# (tests/torch_train_parity.py): JAX against the port reads 1.0e-2 at worst
# here (the 1/16 stage, `update_block16`, and the SST ahead of it), the
# dk-doubled fault 0.83 (both recorded as junit properties)
PLAY_GRAD_TOL = 2e-2


@pytest.fixture(scope="module")
def run():
    b = tp.batch(FRAMES, H, W, seed=1)
    jcfg, tcfg = tp.configs("ppmstereo_vda", FRAMES, ITERS, KWARGS)
    tree = tp.init_tree(tcfg, seed=1)
    rng = np.random.default_rng(0)
    for name in ("update_block16", "update_block08", "update_block04"):
        tree["params"][name]["update_block"]["aggregator"]["beta"][:] = 1.0
    sst = tree["params"]["sst"]
    sst["time_embed"] = rng.normal(0, 0.5, sst["time_embed"].shape).astype(np.float32)
    flat = flatten_params(draw_proj_out(tree, seed=1))
    return dict(batch=b, tcfg=tcfg, flat=flat, jax=tp.jax_step(jcfg, tree, b),
                port=tp.port_step(tcfg, flat, b))


def test_train_step_matches_jax(run, record_property):
    readings = tp.check_step(run["jax"], run["port"], run["flat"], grad_tol=PLAY_GRAD_TOL,
                             encoder_tol=tp.VFM_ENCODER_GRAD_TOL)
    for name, value in readings.items():
        record_property(name, value)
    assert readings["significant"] > 200
    model = run["port"][3]
    frozen = {n.split(".")[0] for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"cnet", "backbone"}
    assert sum(p.numel() for n, p in model.named_parameters() if n.startswith("backbone.")) \
        > 20e6  # ViT-S and its DPT head, all frozen


def test_wrong_play_backward_fails_the_gradient_limit(run, monkeypatch, record_property):
    """dk doubled in the play's backward: the gradients upstream of the
    keys leave the limit."""
    plain = tpa.play_attention_bwd_plain
    monkeypatch.setattr(tpa, "play_attention_bwd_plain",
                        lambda *a: (lambda g: (g[0], 2 * g[1], g[2]))(plain(*a)))
    _, grads, _, _ = tp.port_step(run["tcfg"], run["flat"], run["batch"])
    fault = tp.grad_error(grads, run["jax"][1], encoders=False)[0]
    record_property("fault_grad_error", fault)
    assert fault > PLAY_GRAD_TOL



def test_wrong_encoder_norm_fails_the_encoder_limit(run, record_property):
    tp.check_encoder_norm_fault(run, record_property, encoder_tol=tp.VFM_ENCODER_GRAD_TOL)
