"""One train step of a model of the zoo through the port's trainer and the
JAX package's, shared by tests/test_torch_train_<model>.py: the same
parameters and the same batch of the JAX package's synthetic dataset, in
f32. The parameters are the port's seeded initialisation (`utils/init.py`,
which follows the JAX initializers' distributions) carried to the JAX
model with `utils/weights.py`: a `jax.jit(init)` would compile each model's
forward once more (30-70 s here) for parameters of the same distributions.

The JAX side is the JAX trainer's own: `build_train_model` and
`_wrap_no_uncertainty` (ppmstereo_tpu/train/trainer.py), `sequence_loss`,
`jax.value_and_grad`, and `create_train_state(...).apply_gradients` (the
body of its `make_train_step`). The port's side is `build_train_model`,
`TrainOptimizer` and `train_step`, with the gradients recorded as they
accumulate.

Limits: the loss within LOSS_TOL relative (tests/test_torch_train.py's);
the gradients tensor by tensor, ||port - JAX|| / ||JAX||, over the tensors
whose largest |JAX gradient| is at least SIGNIFICANT_GRAD of the model's
largest (the rest are ~0, e.g. biases ahead of an instance norm, and read
rounding noise): at most GRAD_TOL (tests/test_torch_train.py's), except in
the feature encoders (`fnet`, `cnet`: ENCODER_GRAD_TOL, or the test's own).
There a gradient reaches a parameter through a dozen stacked instance
norms, whose backward cancels most of what comes in, and from a fresh
initialisation f32 rounding is amplified: against a float64 run of the
port, both packages' f32 gradients of a fresh encoder read 1.8e-3 to
1.1e-2 (tests/test_torch_train_dynamic_stereo.py::
test_encoder_gradients_carry_f32_rounding). On the train steps here JAX
against the port reads in the encoders 1.5e-3 to 3.4e-3, and 2.2e-2 for
PPMStereo-VDA (whose VFM encoder's 1/16 maps are 4 x 8: VFM_ENCODER_GRAD_TOL);
each test records its readings as junit properties, and holds a
wrong encoder norm (`check_encoder_norm_fault`: the unbiased variance)
beyond its encoder limit. The updated parameters:
Adam's first update is lr0 * g / (|g| + eps), i.e. +-lr0 wherever the
gradient is not tiny, so an element whose tiny gradient has another sign in
the two packages moves by lr0 one way and the other: every element within
2 lr0 of JAX's (2.01 lr0: with f32 rounding), and at most UPDATE_SHARE of
them off by more than lr0 / 2 (chip_smoke.py's train limit); read 1.7e-5
(BiDAStereo) to 1.6e-3 (PPMStereo-VDA, whose gradients part most).

`tiny_cli_run`: the train CLI's tiny CPU run of one model and its resume.
"""

import json
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppmstereo_tpu.data.datasets import SyntheticStereoDataset
from ppmstereo_tpu.train import trainer as jtrainer
from ppmstereo_tpu.train.loss import sequence_loss as jsequence_loss
from ppmstereo_tpu.train.state import create_train_state
from ppmstereo_tpu_torch.cli import train as train_cli
from ppmstereo_tpu_torch.nn.norm import InstanceNorm
from ppmstereo_tpu_torch.train import trainer as ttrainer
from ppmstereo_tpu_torch.train.checkpoints import CheckpointManager
from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState, onecycle_lr, param_label
from ppmstereo_tpu_torch.train.step import to_device, train_step
from ppmstereo_tpu_torch.utils.weights import (
    flatten_params,
    load_flax_params,
    state_dict_to_flax,
    transposed_kernels,
)
from tests.torch_data_workers import tensorboard_without_tensorflow
from tests.torch_zoo_parity import port_init_tree

LOSS_TOL = 1e-5
GRAD_TOL = 2.5e-3
ENCODER_GRAD_TOL = 1e-2
VFM_ENCODER_GRAD_TOL = 5e-2  # PPMStereo-VDA's MultiLevelEncoderVFM
ENCODERS = ("params/fnet/", "params/cnet/")
SIGNIFICANT_GRAD = 1e-4
UPDATE_SHARE = 1e-2
# XLA's CPU compile with LLVM's expensive passes off: the same function
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}
NUM_STEPS, LR = 1000, 3e-4
LR0 = onecycle_lr(0, NUM_STEPS, LR)  # the first update's rate, LR / 25


def batch(frames: int, h: int, w: int, seed: int = 0) -> dict:
    """One (1, frames, h, w) batch of the JAX package's synthetic dataset."""
    sample = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w,
                                    seed=seed)[0]
    return {"left": sample["img"][None, :, 0], "right": sample["img"][None, :, 1],
            "disparity": sample["disp"][None, :, 0], "valid": sample["valid"][None, :, 0]}


def configs(name: str, frames: int, iters: int, model_kwargs: dict | None = None):
    """The JAX and the port's TrainConfig of one f32 step."""
    kwargs = dict(model_name=name, sample_len=frames, train_iters=iters,
                  mixed_precision=False, model_kwargs=model_kwargs)
    return jtrainer.TrainConfig(**kwargs), ttrainer.TrainConfig(**kwargs)


def init_tree(tcfg, seed: int = 0) -> dict:
    """The port's model of `tcfg` at `init_model(seed)`, as a writable
    nested {"params": ...} numpy tree for the JAX model."""
    return port_init_tree(ttrainer.build_train_model(tcfg)[0], seed)


def jax_step(jcfg, tree: dict, b: dict):
    """The JAX trainer's step: (loss, flat gradients, flat parameters after
    the update)."""
    model, has_unc = jtrainer.build_train_model(jcfg)
    step_model = model if has_unc else jtrainer._wrap_no_uncertainty(model)
    j = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        preds, uncs = step_model.apply(params, j["left"], j["right"])
        return jsequence_loss(preds, j["disparity"], j["valid"], uncertainties=uncs)[0]

    # LLVM's expensive passes off: the same function, compiled faster (as
    # tests/test_torch_data_train.py compiles its step)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn), compiler_options=FAST_COMPILE)(tree)
    state = create_train_state(step_model, tree, num_steps=NUM_STEPS, lr=LR)
    state = state.apply_gradients(grads=grads)
    host = lambda t: flatten_params(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return float(loss), host(grads), host(state.params)


def jax_ppm_step(tree: dict, b: dict, num_frames: int = 5, iters: int = 2):
    """The JAX trainer's step of the tiny PPMStereo (f32, the anchor's
    `num_frames`-frame time embedding, `iters` iterations) on the batch
    `b`: ((loss, flat gradients, flat parameters after the update), the
    metrics). The whole model's value_and_grad is compiled with LLVM's
    expensive passes off (FAST_COMPILE): the same function."""
    jcfg, _ = configs("ppmstereo", num_frames, iters)
    model, _ = jtrainer.build_train_model(jcfg)
    j = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(params):
        preds, uncs = model.apply(params, j["left"], j["right"])
        return jsequence_loss(preds, j["disparity"], j["valid"], uncertainties=uncs)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(tree).compile(
        compiler_options=FAST_COMPILE)
    (loss, metrics), grads = step(tree)
    state = create_train_state(model, tree, num_steps=NUM_STEPS, lr=LR)
    state = state.apply_gradients(grads=grads)
    host = lambda t: flatten_params(jax.tree_util.tree_map(np.asarray, t))  # noqa: E731
    return (float(loss), host(grads), host(state.params)), {k: float(v) for k, v in
                                                             metrics.items()}


def port_model(tcfg, flat: dict):
    model, has_unc = ttrainer.build_train_model(tcfg)
    load_flax_params(model, flat)
    return model, has_unc


def port_step(tcfg, flat: dict, b: dict, plant=None):
    """The port's train_step: (loss, flat gradients of the trainable
    tensors, flat parameters and buffers after the update, the model).
    `plant(model)`, where given, changes the model before the step (a
    fault)."""
    model, has_unc = port_model(tcfg, flat)
    if plant is not None:
        plant(model)
    state = TrainState(model, TrainOptimizer(model, num_steps=NUM_STEPS, lr=LR), has_unc)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters() if p.requires_grad]
    state, metrics = train_step(state, to_device(b, torch.device("cpu")))
    for h in hooks:
        h.remove()
    tk = transposed_kernels(model)
    return (float(metrics["loss"]), state_dict_to_flax(grads, tk),
            state_dict_to_flax(model.state_dict(), tk), model)


def label(flax_name: str) -> str:
    """The port's partition of a flat flax name (the prefixes are the same
    paths with dots)."""
    return param_label(flax_name.replace("params/", "").replace("/", "."))


def grad_error(got: dict, want: dict, encoders: bool | None = None
               ) -> tuple[float, int, str]:
    """The worst ||got - want|| / ||want|| over the significant tensors of
    `want` that `got` has (of the feature encoders only, or none of them,
    when `encoders` says so), their number, and the worst one's name."""
    top = max(np.abs(want[k]).max() for k in got)
    errs = [(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]), k) for k in got
            if np.abs(want[k]).max() >= SIGNIFICANT_GRAD * top
            and encoders in (None, k.startswith(ENCODERS))]
    worst, name = max(errs)
    return float(worst), len(errs), name


def update_error(got: dict, want: dict, names) -> tuple[float, float]:
    """Over the elements of `names`: the largest |got - want| in units of
    LR0, and the share off by more than LR0 / 2."""
    worst, off, total = 0.0, 0, 0
    for k in names:
        d = np.abs(got[k].astype(np.float64) - want[k])
        worst = max(worst, float(d.max()) / LR0)
        off += int((d > LR0 / 2).sum())
        total += d.size
    return worst, off / total


def check_step(jax_run, port_run, start: dict, grad_tol: float = GRAD_TOL,
               encoder_tol: float = ENCODER_GRAD_TOL) -> dict:
    """The parity of one step: the loss, the gradient set (JAX's less the
    frozen partition) and each significant gradient (within `grad_tol`
    outside the feature encoders, `encoder_tol` in them), the updated
    trainable parameters, and the frozen tensors bit-equal to `start`.
    Returns the readings (the tests record them as junit properties)."""
    jl, jg, jp = jax_run
    tl, tg, tp, _ = port_run
    trainable = {k for k in jg if label(k) != "frozen"}
    frozen = [k for k in tp if label(k) == "frozen"]
    assert set(tg) == trainable
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    err, n, name = grad_error(tg, jg, encoders=False)
    enc_err, n_enc, enc_name = grad_error(tg, jg, encoders=True)
    assert err <= grad_tol, (err, name)
    assert enc_err <= encoder_tol, (enc_err, enc_name)
    worst, share = update_error(tp, jp, trainable)
    assert worst <= 2.01 and share <= UPDATE_SHARE, (worst, share)
    for k in frozen:
        np.testing.assert_array_equal(tp[k], start[k], err_msg=k)
    return dict(grad_error=err, encoder_grad_error=enc_err, significant=n + n_enc,
                update_worst=worst, update_share=share, frozen=len(frozen))


def _unbiased_instance_norm(self, x):
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(x.dim() - 3, x.dim() - 2), keepdim=True, correction=1)
    return ((x32 - mean) / torch.sqrt(var + self.epsilon)).to(x.dtype)


def unbiased_encoder_norms(model) -> None:
    """The fault: the feature encoders' instance norms with the unbiased
    variance (torch.var's default; the JAX norm divides by the count)."""
    norms = [m for n, m in model.named_modules()
             if n.startswith(("fnet.", "cnet.")) and isinstance(m, InstanceNorm)]
    assert norms
    for m in norms:
        m.forward = types.MethodType(_unbiased_instance_norm, m)


def check_encoder_norm_fault(run: dict, record_property,
                             encoder_tol: float = ENCODER_GRAD_TOL) -> None:
    """The port's step of a test's `run` fixture with a wrong encoder norm
    (`unbiased_encoder_norms`): the encoders' gradients leave `encoder_tol`."""
    grads = port_step(run["tcfg"], run["flat"], run["batch"], plant=unbiased_encoder_norms)[1]
    fault = grad_error(grads, run["jax"][1], encoders=True)[0]
    record_property("fault_encoder_grad_error", fault)
    assert fault > encoder_tol


def tiny_cli_run(name: str, tmp_path, frames: int = 2):
    """The train CLI on the CPU for model `name` at 64x128: one step,
    metrics every step, a checkpoint holding every tensor of the model (the
    frozen ones too) and the optimiser; a second call with 2 steps resumes
    from it and takes one more. In f32: PyTorch's bf16 convolutions on the
    CPU are far slower (minutes a step with 2 threads). The checkpoints are
    deleted at the end: pytest keeps its last runs' temporary directories."""
    tensorboard_without_tensorflow()
    args = ["--name", name, "--device", "cpu", "--image_size", "64", "128", "--sample_len",
            str(frames), "--train_iters", "1", "--num_workers", "1", "--no_mixed_precision",
            "--ckpt_path", str(tmp_path), "log_freq=1"]
    state = train_cli.main(args + ["--num_steps", "1"])
    assert state.step == 1 and state.optimizer.count == 1
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.steps() == [1]
    saved = torch.load(tmp_path / "ckpt" / "step_1.pt", weights_only=True)
    assert saved["step"] == 1 and saved["optimizer"]["count"] == 1
    model = state.model.state_dict()
    assert set(saved["model"]) == set(model)
    for k, v in model.items():
        torch.testing.assert_close(saved["model"][k], v, rtol=0, atol=0, msg=k)
    state = train_cli.main(args + ["--num_steps", "2"])
    assert state.step == 2 and state.optimizer.count == 2 and mgr.steps() == [1, 2]
    for k, v in state.model.state_dict().items():
        if param_label(k) == "frozen":
            torch.testing.assert_close(v, saved["model"][k], rtol=0, atol=0, msg=k)
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["steps_per_s"] > 0 for r in records)
    shutil.rmtree(tmp_path / "ckpt")  # up to 1.5 GB (PPMStereo-VDA's two checkpoints)
    return state
