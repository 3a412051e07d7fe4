"""Training DynamicStereo (`--name dynamicstereo`): one port train step
against the JAX trainer's (tests/torch_train_parity.py: the loss, every
gradient, the updated parameters; DynamicStereo has no frozen part and no
uncertainty head), a wrong forward that must fail the limits, and the
trainer's model table against the JAX trainer's: the six names, their
uncertainty heads, the refused name, and the in-training evaluation's zoo
model and arguments; and the f32 rounding that the feature encoders'
gradients carry, against float64.

Weights: the port's seeded initialisation carried to the JAX model
(tests/torch_train_parity.py), with the SST time embedding and the temporal
attention's output projection drawn (zero at init;
tests/torch_zoo_parity.py). Input: a (1, 3, 64, 128) synthetic batch, 2
iterations (1 + 1 + 2). Without the play step both packages run every
operation in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import zoo as jzoo
from ppmstereo_tpu.nn import encoder as jenc
from ppmstereo_tpu.train import trainer as jtrainer
from ppmstereo_tpu_torch.models import dynamic_stereo as tds
from ppmstereo_tpu_torch.models import zoo as tzoo
from ppmstereo_tpu_torch.nn import encoder as tenc
from ppmstereo_tpu_torch.nn import norm as tnorm
from ppmstereo_tpu_torch.train import trainer as ttrainer
from ppmstereo_tpu_torch.utils.weights import (
    flatten_params,
    load_flax_params,
    state_dict_to_flax,
)
from tests import torch_train_parity as tp
from tests.torch_zoo_parity import draw_zero_leaves, port_init_tree

torch.set_num_threads(2)
FRAMES, H, W, ITERS = 3, 64, 128, 2
NAMES = ("ppmstereo", "memstereo", "ppmstereo_vda", "dynamicstereo", "bidastereo",
         "stereoanyvideo")


@pytest.fixture(scope="module")
def run():
    b = tp.batch(FRAMES, H, W, seed=2)
    jcfg, tcfg = tp.configs("dynamicstereo", FRAMES, ITERS)
    tree = draw_zero_leaves(tp.init_tree(tcfg, seed=2), seed=2)
    flat = flatten_params(tree)
    return dict(batch=b, tcfg=tcfg, flat=flat, jax=tp.jax_step(jcfg, tree, b),
                port=tp.port_step(tcfg, flat, b))


def test_train_step_matches_jax(run, record_property):
    readings = tp.check_step(run["jax"], run["port"], run["flat"])
    for name, value in readings.items():
        record_property(name, value)
    assert readings["significant"] > 100 and readings["frozen"] == 0


def test_negated_stage_flow_fails_the_limits(run, monkeypatch, record_property):
    """The fault: each stage seeded with the coarser flow not negated (the
    reference negates it)."""
    interp = tds.interp_bilinear
    monkeypatch.setattr(tds, "interp_bilinear",
                        lambda x, hw: -interp(x, hw) if x.shape[-1] == 2 else interp(x, hw))
    loss, grads, _, _ = tp.port_step(run["tcfg"], run["flat"], run["batch"])
    jl, jg, _ = run["jax"]
    assert abs(loss - jl) > tp.LOSS_TOL * abs(jl)
    fault = tp.grad_error(grads, jg, encoders=False)[0]
    record_property("fault_grad_error", fault)
    assert fault > tp.GRAD_TOL


def test_wrong_encoder_norm_fails_the_encoder_limit(run, record_property):
    tp.check_encoder_norm_fault(run, record_property)


@pytest.mark.parametrize("name", [*NAMES, "raftstereo"])
def test_build_train_model_matches_the_jax_table(name):
    """Each name builds the JAX `build_train_model`'s model class with its uncertainty
    head or without; an unknown name (RAFT-Stereo has no train name) raises
    as in the JAX package."""
    cfg = dict(model_name=name, sample_len=3, train_iters=2)
    if name == "raftstereo":
        for build, train_cfg in ((jtrainer.build_train_model, jtrainer.TrainConfig),
                                 (ttrainer.build_train_model, ttrainer.TrainConfig)):
            with pytest.raises(ValueError, match="unknown model raftstereo"):
                build(train_cfg(**cfg))
        return
    jm, j_unc = jtrainer.build_train_model(jtrainer.TrainConfig(**cfg))
    tm, t_unc = ttrainer.build_train_model(ttrainer.TrainConfig(**cfg))
    assert t_unc == j_unc == (name in ("ppmstereo", "memstereo", "ppmstereo_vda"))
    assert type(tm).__name__ == type(jm).__name__
    assert tm.cfg.mixed_precision == jm.cfg.mixed_precision
    assert getattr(tm.cfg, "use_vfm", False) == getattr(jm.cfg, "use_vfm", False)
    assert getattr(tm.cfg, "num_frames", None) == getattr(jm.cfg, "num_frames", None)
    assert not tm.test_mode and not jm.test_mode


@pytest.mark.parametrize("name", NAMES)
def test_eval_predictor_matches_the_jax_table(name, monkeypatch):
    """The in-training evaluation's predictor: the JAX trainer's zoo model
    and arguments (num_frames for the four models with an SST), recorded
    at each zoo's registered constructor."""
    calls = {}

    def recorder(package):
        def record(name_, **kwargs):
            calls[package] = (name_, kwargs)
        return record

    for name_ in list(jzoo._REGISTRY):
        monkeypatch.setitem(jzoo._REGISTRY, name_,
                            lambda _n=name_, **kw: recorder("jax")(_n, **kw))
    monkeypatch.setattr(tzoo, "model_zoo", recorder("port"))
    cfg = dict(model_name=name, sample_len=3, mixed_precision=False)
    jtrainer.build_eval_predictor(jtrainer.TrainConfig(**cfg), params={"p": 1})
    ttrainer.build_eval_predictor(ttrainer.TrainConfig(**cfg), params={"p": 1}, device="cpu")
    (jname, jkw), (tname, tkw) = calls["jax"], calls["port"]
    assert tname == jname
    assert tkw.pop("device") == "cpu"
    assert tkw == jkw
    assert ("num_frames" in tkw) == (name != "bidastereo" and name != "stereoanyvideo")
    assert tkw["iters"] == tkw["kernel_size"] == 10


def _instance_norm_f64(self, x):
    var, mean = torch.var_mean(x, dim=(x.dim() - 3, x.dim() - 2), keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + self.epsilon)


@pytest.mark.parametrize("encoder", ["BasicEncoder", "MultiLevelEncoderVFM"])
def test_encoder_gradients_carry_f32_rounding(encoder, monkeypatch, record_property):
    """Why the feature encoders' gradients have their own limit
    (tests/torch_train_parity.py's ENCODER_GRAD_TOL, and VFM_ENCODER_GRAD_TOL
    for PPMStereo-VDA's MultiLevelEncoderVFM): the kernel gradients
    of a freshly initialised encoder (6 images at 64x128, a seeded random
    cotangent) in f32, in JAX and in the port, against the port in float64
    (its InstanceNorm's statistics in f64 too). Both f32 readings stay
    within the encoder's limit; they are recorded as the test's junit properties
    (measured here, the worst kernel: BasicEncoder JAX 1.8e-3, the port
    6.2e-3; MultiLevelEncoderVFM 9.8e-3 and 1.1e-2)."""
    rng = np.random.default_rng(0)
    b = tp.batch(3, 64, 128, seed=2)
    x = (2.0 * (np.concatenate([b["left"][0], b["right"][0]]) / 255.0) - 1.0).astype(np.float32)
    vfm = [rng.normal(size=(6, 64 // s, 128 // s, 64)).astype(np.float32) for s in (4, 8, 16, 32)]
    if encoder == "BasicEncoder":
        jm, make, args, kwargs = jenc.BasicEncoder(output_dim=256), tenc.BasicEncoder, (x,), {}
    else:
        jm, make = jenc.MultiLevelEncoderVFM(output_dim=256), tenc.MultiLevelEncoderVFM
        args, kwargs = (x, vfm), {"vfm_dim": 64}
    tree = port_init_tree(make(256, **kwargs), seed=0)
    outs = jax.eval_shape(jm.apply, tree, *jax.tree_util.tree_map(jnp.asarray, args))
    cots = [rng.standard_normal(o.shape).astype(np.float32)
            for o in jax.tree_util.tree_leaves(outs)]

    def objective(params):
        out = jm.apply(params, *jax.tree_util.tree_map(jnp.asarray, args))
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(o * c) for o, c in zip(leaves, cots))

    want = flatten_params(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(objective))(tree)))
    got = {}
    for dtype in (torch.float32, torch.float64):
        if dtype == torch.float64:
            monkeypatch.setattr(tnorm.InstanceNorm, "forward", _instance_norm_f64)
        model = make(256, dtype=dtype, **kwargs)
        load_flax_params(model, flatten_params(tree))
        model = model.to(dtype)
        t_args = [torch.from_numpy(a).to(dtype) if isinstance(a, np.ndarray)
                  else [torch.from_numpy(v).to(dtype) for v in a] for a in args]
        out = model(*t_args)
        leaves = out if isinstance(out, tuple) else (out,)
        sum((o * torch.from_numpy(c).to(dtype)).sum() for o, c in zip(leaves, cots)).backward()
        got[dtype] = state_dict_to_flax({n: p.grad.double() for n, p in model.named_parameters()})
    truth = got[torch.float64]
    kernels = [k for k in truth if k.endswith("kernel")]
    errs = {side: max(np.linalg.norm(g[k] - truth[k]) / np.linalg.norm(truth[k]) for k in kernels)
            for side, g in (("jax", want), ("port", got[torch.float32]))}
    limit = tp.ENCODER_GRAD_TOL if encoder == "BasicEncoder" else tp.VFM_ENCODER_GRAD_TOL
    for side, err in errs.items():
        record_property(f"{encoder}_{side}_f32_vs_f64", float(err))
        assert err <= limit, (side, err)
