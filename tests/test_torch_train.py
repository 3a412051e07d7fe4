"""The port's training path against the JAX package's: the sequence loss,
the one-cycle schedule, the optimiser (partitions, two clips, the finite
guard), the initialisation, one whole train step against
`jax.value_and_grad`, checkpoints, the npz export and the CLI.

Inputs come from numpy with a seed, weights from the committed anchor
carried with `utils/weights.py`, images from the JAX package's synthetic
dataset. Both models run in f32, except the play step's q/k/v and
probabilities, which both round to bf16.

Gradient limit of the whole-model step: tensor by tensor, the norm of
port - JAX over the norm of JAX's gradient, over the tensors whose largest
|JAX gradient| is at least 1e-4 of the model's largest (the rest are biases
ahead of an instance norm, whose true gradient is 0: they read ~1e-9,
rounding noise). Both packages round the play step's gradients to bf16, so
where the f32 sums upstream differ in their last bits (another reduction
order: it depends on the thread count) some of those roundings flip.
Measured on the CPU with 2 threads: 6.7e-4 at worst (the 1/4 stage's value
projection `to_v`, 1.2e-3 of its largest gradient); with 4 threads 1.3e-5;
with a wrong backward (dk doubled) 8.4e-3. The limit, 2.5e-3, sits between
them, ~3.5x from each.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.data.datasets import SyntheticStereoDataset
from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JConfig
from ppmstereo_tpu.train.loss import sequence_loss as jsequence_loss
from ppmstereo_tpu.train.state import make_optimizer, onecycle_schedule
from ppmstereo_tpu_torch.cli import train as tcli
from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.train import checkpoints as tckpt
from ppmstereo_tpu_torch.train import loss as tloss
from ppmstereo_tpu_torch.train import state as tstate
from ppmstereo_tpu_torch.train import trainer as ttrainer
from ppmstereo_tpu_torch.utils import init as tinit
from ppmstereo_tpu_torch.utils import weights as tweights
from tests.torch_data_workers import tensorboard_without_tensorflow
from tests.torch_train_parity import FAST_COMPILE, tiny_cli_run

torch.set_num_threads(2)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
LOSS_TOL = 1e-5
GRAD_TOL = 2.5e-3
SIGNIFICANT_GRAD = 1e-4


def _tree(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def anchor():
    flat = {k: v.astype(np.float32) for k, v in tweights.load_npz(ANCHOR).items()}
    return flat, _tree(flat)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("n,with_unc", [(20, True), (20, False), (1, True)])
def test_sequence_loss_matches_jax(rng, n, with_unc):
    preds = rng.normal(0, 30, (n, 2, 3, 8, 12, 1)).astype(np.float32)
    gt = rng.normal(0, 30, (2, 3, 8, 12, 2)).astype(np.float32)
    gt[0, 0, 0, :4, 0] = 800.0  # past max_flow: excluded
    valid = (rng.random((2, 3, 8, 12)) > 0.2).astype(np.float32)
    unc = rng.random(preds.shape).astype(np.float32) if with_unc else None
    jl, jm = jsequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid),
                            uncertainties=None if unc is None else jnp.asarray(unc))
    tl, tm = tloss.sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                                 torch.from_numpy(valid),
                                 uncertainties=None if unc is None else torch.from_numpy(unc))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert set(tm) == set(jm) == {"epe", "1px", "3px", "5px"}
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6)


# ------------------------------------------------------------- optimiser
@pytest.mark.parametrize("num_steps", [1000, 200_000])
def test_onecycle_schedule_matches_optax(num_steps):
    sched = onecycle_schedule(num_steps, 3e-4)
    total = num_steps + 100
    peak = int(0.01 * total)
    for step in (0, 1, peak - 1, peak, peak + 1, total // 2, total - 1, total, total + 500):
        assert tstate.onecycle_lr(step, num_steps, 3e-4) == pytest.approx(
            float(sched(step)), rel=1e-6), step


class _Tiny(torch.nn.Module):
    """Parameters named like the three partitions: `cnet.convnext.*`
    (frozen), `sst.time_embed` (no decay) and the rest (train)."""

    def __init__(self, rng):
        super().__init__()
        p = lambda *shape: torch.nn.Parameter(torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)))
        self.cnet = torch.nn.Module()
        self.cnet.convnext = torch.nn.Module()
        self.cnet.convnext.w = p(3, 4)
        self.sst = torch.nn.Module()
        self.sst.time_embed = p(1, 5, 4)
        self.head = torch.nn.Module()
        self.head.w = p(6, 4)
        self.head.b = p(6)

    def jax_params(self):
        return {"params": {
            "cnet": {"convnext": {"w": self.cnet.convnext.w.detach().numpy().copy()}},
            "sst": {"time_embed": self.sst.time_embed.detach().numpy().copy()},
            "head": {"w": self.head.w.detach().numpy().copy(), "b": self.head.b.detach().numpy().copy()},
        }}


def test_optimizer_steps_match_optax(rng):
    """16 updates: clipped and unclipped gradients, one non-finite gradient
    (skipped), then 11 non-finite in a row: 10 are skipped, the 11th is
    applied (optax's apply_if_finite gives up and accepts), then a finite
    one."""
    model = _Tiny(rng)
    params = model.jax_params()
    tx = make_optimizer(num_steps=50, lr=3e-2)
    opt_state = tx.init(params)
    opt = tstate.TrainOptimizer(model, num_steps=50, lr=3e-2)
    assert not model.cnet.convnext.w.requires_grad
    bad = [False, True, False, False] + [True] * 11 + [False]
    for i, nonfinite in enumerate(bad):
        scale = 5.0 if i % 2 else 0.05  # global norms above and below the clip
        g = {"head/w": scale * rng.standard_normal((6, 4)), "head/b": scale * rng.standard_normal(6),
             "time_embed": rng.standard_normal((1, 5, 4)), "convnext": rng.standard_normal((3, 4))}
        g = {k: v.astype(np.float32) for k, v in g.items()}
        if nonfinite:
            g["head/w"][1, 2] = np.nan if i % 2 else np.inf
        grads = {"params": {"cnet": {"convnext": {"w": g["convnext"]}},
                            "sst": {"time_embed": g["time_embed"]},
                            "head": {"w": g["head/w"], "b": g["head/b"]}}}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jax.tree_util.tree_map(jnp.asarray, params))
        params = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(
            lambda p, u: p + u, params, updates))
        model.head.w.grad = torch.from_numpy(g["head/w"].copy())
        model.head.b.grad = torch.from_numpy(g["head/b"].copy())
        model.sst.time_embed.grad = torch.from_numpy(g["time_embed"].copy())
        opt.step()
        want = params["params"]
        for got, ref in ((model.head.w, want["head"]["w"]), (model.head.b, want["head"]["b"]),
                         (model.sst.time_embed, want["sst"]["time_embed"]),
                         (model.cnet.convnext.w, want["cnet"]["convnext"]["w"])):
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5, atol=1e-6,
                                       equal_nan=True, err_msg=f"update {i}")
        assert opt.notfinite_count == int(opt_state.notfinite_count)
        assert opt.total_notfinite == int(opt_state.total_notfinite)
    assert opt.count == 5  # updates 0, 2, 3, the 11th non-finite one and the last
    assert np.isnan(model.head.w.detach().numpy()).any()  # the accepted non-finite update


# ------------------------------------------------------------------ init
@pytest.fixture(scope="module")
def jax_init():
    model = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                       iters=1, test_mode=True)
    x = jnp.zeros((1, 2, 64, 64, 3))
    key = jax.random.PRNGKey(0)
    # LLVM at -O0: the same parameters bit for bit, and about half of the
    # compile's CPU time (the init runs in ~2 s either way)
    init = jax.jit(model.init).lower(key, x, x).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return tweights.flatten_params(jax.tree_util.tree_map(np.asarray, init(key, x, x)))


def test_init_follows_the_jax_initializers(jax_init):
    """Names and shapes equal PPMStereo.init's; every kernel of fan-in >= 64
    (and >= 1024 values, so that the std estimate holds to ~3 %) has its std
    within 10 % of JAX's; tensors JAX initialises to a constant (zeros,
    ones) are that constant."""
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=1)
    tinit.init_model(model, seed=0)
    got = tweights.state_dict_to_flax(model.state_dict())
    assert set(got) == set(jax_init)
    checked = 0
    for name, want in jax_init.items():
        g = got[name]
        assert g.shape == want.shape, name
        if want.size > 1 and np.all(want == want.flat[0]):
            np.testing.assert_array_equal(g, want, err_msg=name)
        elif name.endswith("kernel") and np.prod(want.shape[:-1]) >= 64 and want.size >= 1024:
            assert g.std() == pytest.approx(want.std(), rel=0.1), name
            checked += 1
    assert checked > 150  # 195 kernels qualify


# --------------------------------------------------- whole-model train step
def _batch():
    sample = SyntheticStereoDataset(num_seqs=1, sample_len=3, height=64, width=128, seed=0)[0]
    return {"left": sample["img"][None, :, 0], "right": sample["img"][None, :, 1],
            "disparity": sample["disp"][None, :, 0], "valid": sample["valid"][None, :, 0]}


def _port_loss_and_grads(flat, batch, wrong_dk=False, monkeypatch=None):
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=2)
    tweights.load_flax_params(model, flat)
    for name, p in model.named_parameters():
        p.requires_grad_(tstate.param_label(name) != "frozen")
    if wrong_dk:
        plain = tpa.play_attention_bwd_plain
        monkeypatch.setattr(tpa, "play_attention_bwd_plain",
                            lambda *a: (lambda g: (g[0], 2 * g[1], g[2]))(plain(*a)))
    preds, uncs = model(torch.from_numpy(batch["left"]), torch.from_numpy(batch["right"]))
    loss, _ = tloss.sequence_loss(preds, torch.from_numpy(batch["disparity"]),
                                  torch.from_numpy(batch["valid"]), uncertainties=uncs)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return float(loss.detach()), tweights.state_dict_to_flax(grads)


def _grad_error(got, want):
    top = max(np.abs(want[k]).max() for k in got)
    errs = [np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            for k in got if np.abs(want[k]).max() >= SIGNIFICANT_GRAD * top]
    return max(errs), len(errs)


def test_train_step_matches_jax_value_and_grad(anchor, monkeypatch):
    """One train step's loss and gradients at f32, 3 frames, 64x128,
    iters 2 (1 + 1 + 2 iterations over the three stages), from the anchor,
    against jax.value_and_grad of the JAX model and loss; a wrong backward
    of the play step (dk doubled) must fail the gradient limit."""
    flat, tree = anchor
    batch = _batch()
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                    iters=2, test_mode=False)

    def loss_fn(params):
        preds, uncs = jm.apply(params, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]))
        return jsequence_loss(preds, jnp.asarray(batch["disparity"]), jnp.asarray(batch["valid"]),
                              uncertainties=uncs)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn), compiler_options=FAST_COMPILE)(tree)
    jg = tweights.flatten_params(jax.tree_util.tree_map(np.asarray, jg))

    tl, tg = _port_loss_and_grads(flat, batch)
    assert set(tg) == {k for k in jg if tstate.param_label(
        k.replace("params/", "").replace("/", ".")) != "frozen"}
    assert abs(tl - float(jl)) <= LOSS_TOL * abs(float(jl))
    err, n = _grad_error(tg, jg)
    assert n > 200
    assert err <= GRAD_TOL

    _, fg = _port_loss_and_grads(flat, batch, wrong_dk=True, monkeypatch=monkeypatch)
    assert _grad_error(fg, jg)[0] > GRAD_TOL


def test_train_mode_reuses_the_forward_picks_in_the_recomputation(anchor, monkeypatch):
    """Each checkpointed iteration picks its frames once: the backward pass
    recomputes the iteration without calling topk again."""
    flat, _ = anchor
    batch = _batch()
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=2)
    tweights.load_flax_params(model, flat)
    calls = []
    topk = torch.topk
    monkeypatch.setattr(torch, "topk", lambda *a, **k: calls.append(1) or topk(*a, **k))
    picks = []
    preds, uncs = model(torch.from_numpy(batch["left"]), torch.from_numpy(batch["right"]),
                        picks=picks)
    assert preds.shape == uncs.shape == (4, 1, 3, 64, 128, 1)
    assert len(calls) == len(picks) == 4
    (preds.mean() + uncs.mean()).backward()
    assert len(calls) == 4


# ------------------------------------------------ checkpoints and export
def test_checkpoint_save_and_resume_round_trip(rng, tmp_path):
    model = _Tiny(rng)
    state = tstate.TrainState(model, tstate.TrainOptimizer(model, num_steps=100), True)
    for p in (model.head.w, model.head.b, model.sst.time_embed):
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    model.head.w.grad = torch.full_like(model.head.w, np.nan)
    state.optimizer.step()  # skipped: the guard counts it
    state.step = 2
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    mgr.save(state)

    other = _Tiny(np.random.default_rng(1))
    restored = tstate.TrainState(other, tstate.TrainOptimizer(other, num_steps=100), True)
    assert mgr.restore(restored)
    assert restored.step == 2
    for (name, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert restored.optimizer.state_dict()["count"] == 1
    assert restored.optimizer.notfinite_count == restored.optimizer.total_notfinite == 1
    moments = restored.optimizer.adamw.state_dict()["state"]
    torch.testing.assert_close(moments, state.optimizer.adamw.state_dict()["state"])

    for step in (3, 4, 5):
        state.step = step
        mgr.save(state)
    assert mgr.steps() == [4, 5]
    assert not tckpt.CheckpointManager(tmp_path / "empty").restore(restored)


def test_npz_export_round_trip(anchor, tmp_path):
    """The export writes the anchor's layout: the same names and shapes,
    readable back into the port (and by both packages' load_npz)."""
    flat, _ = anchor
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=1)
    tinit.init_model(model, seed=3)
    tweights.export_npz(model, tmp_path / "export.npz")
    exported = tweights.load_npz(tmp_path / "export.npz")
    assert {k: v.shape for k, v in exported.items()} == {k: v.shape for k, v in flat.items()}
    back = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=1)
    tweights.load_flax_params(back, exported)
    for (name, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    # and the inverse of the carry on the anchor itself
    carried = tweights.state_dict_to_flax(tweights.flax_to_state_dict(flat))
    for k, v in flat.items():
        np.testing.assert_array_equal(carried[k], v, err_msg=k)


# ------------------------------------------------------ trainer and CLI
def test_trainer_and_cli_require_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.train(ttrainer.TrainConfig(num_steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--num_steps", "1"])
    with pytest.raises(ValueError, match="unknown model raftstereo"):
        ttrainer.train(ttrainer.TrainConfig(model_name="raftstereo"), device="cpu")


def test_cli_tiny_run_on_the_cpu_and_resume(tmp_path):
    """The README's tiny CPU run (`tiny_cli_run`) of PPMStereo."""
    tiny_cli_run("ppmstereo", tmp_path)


def test_trainer_raises_when_the_loader_runs_dry(tmp_path):
    """A one-shot loader that yields fewer batches than the run's steps
    ends the run with an error instead of looping forever."""
    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader

    cfg = ttrainer.TrainConfig(crop_size=(64, 128), sample_len=3, batch_size=1, train_iters=1,
                               mixed_precision=False, num_workers=1, exp_dir=str(tmp_path))
    batch = next(iter(fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                       batch_size=1, num_workers=1, seed=0)))
    tensorboard_without_tensorflow()
    with pytest.raises(ValueError, match="yielded no batch at step 1 of 2"):
        ttrainer.train(cfg, loader=iter([batch]), max_steps=2, device="cpu")
