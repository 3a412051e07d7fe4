#!/usr/bin/env python3
"""Where the play attention's dk reaches PPMStereo-VDA's `att_0.to_qk`.

    python3 tools/dk_trace.py [--out chiprun_out/dk_trace.json]

On `chip_smoke.py` phase train_zoo's small f32 PPMStereo-VDA step (the
seeded initialisation with the play blends on, a 2-frame 64x128 clip, 2
iterations), one train step each way:

  * cpu, cpu dk x2: the CPU path (the plain play and its plain backward),
    sound and with the backward's dk doubled;
  * cuda plain, cuda plain dk x2: the card with the plain play and plain
    backward on CUDA tensors (`kernels/play_attention.py::_on_cpu` made
    true), sound and with dk doubled;
  * cuda kernels, cuda kernels dk x2: the card's kernels 2-4, sound and with
    the kernels' dk doubled (phase train_zoo's "dk" fault).

For each way: the gradient of `att_0.to_qk` (its norm, its largest entry
against the model's largest, which phase train_zoo's significance rule
reads, and its distance from the CPU's sound gradient by that phase's norm
ratio), the loss, and for every play backward call its shape, |dk|, |dq| and
|dv|; with the kernels, each call's dk against the plain backward's on the
same inputs. Also the gradient that reaches `att_0.to_qk`'s output, split
into its query and key halves. Runs on the card (and the CPU); imports no
JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

NAME = "ppmstereo_vda"
TENSOR = "att_0.to_qk.Conv_0.weight"


@contextmanager
def _patched(owner, name: str, fn):
    old = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _recorder(pa, backward_name: str, calls: list, against_plain: bool):
    """A wrapper of pa.<backward_name> that records each call's shapes and
    gradient norms (and, for the kernels, dk against the plain backward)."""
    fn = getattr(pa, backward_name)

    @functools.wraps(fn)  # keeps the name that phase train_zoo's fault patches
    def recorded(*args):
        dq, dk, dv = fn(*args)
        q, k = args[0], args[1]
        row = dict(b=q.shape[0], lq=q.shape[1], lk=k.shape[1],
                   dq=float(dq.float().norm()), dk=float(dk.float().norm()),
                   dv=float(dv.float().norm()))
        if against_plain:
            q, k, v, _, _, do, scale = args
            plain_dk = pa.play_attention_bwd_plain(q, k, v, do, scale)[1].float()
            row["dk_vs_plain"] = float((dk.float() - plain_dk).abs().max()
                                       / plain_dk.abs().max().clamp_min(1e-30))
        calls.append(row)
        return dq, dk, dv

    return recorded


def _qk_output_grads(model, grads: list):
    """Hooks that record |d loss / d to_qk output| of att_0, query and key
    halves, at every forward (the checkpointed recompute included)."""
    att = model.att_0

    def forward_hook(module, inputs, out):
        if out.requires_grad:
            half = att.dim_head
            out.register_hook(lambda g: grads.append(
                dict(query=float(g[..., :half].float().norm()),
                     key=float(g[..., half:].float().norm()))))

    return att.to_qk.register_forward_hook(forward_hook)


def run_way(way: str, flat, batch: dict) -> dict:
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.train import trainer

    dev = "cpu" if way.startswith("cpu") else "cuda"
    kernels = "kernels" in way
    doubled = way.endswith("dk x2")
    backward_name = "play_attention_bwd" if kernels else "play_attention_bwd_plain"
    calls, out_grads = [], []
    hooks = []
    build = trainer.build_train_model

    def build_and_hook(cfg):
        model, has_uncertainty = build(cfg)
        hooks.append(_qk_output_grads(model, out_grads))
        return model, has_uncertainty

    recorded = _recorder(pa, backward_name, calls, against_plain=kernels)
    with _patched(pa, backward_name, recorded), \
            _patched(trainer, "build_train_model", build_and_hook), \
            _patched(pa, "_on_cpu", pa._on_cpu if (dev == "cpu" or kernels)
                     else (lambda *xs: True)):
        if doubled and not kernels:  # the plain backward's dk doubled here
            with _patched(pa, backward_name,
                          lambda *a: (lambda g: (g[0], 2 * g[1], g[2]))(recorded(*a))):
                loss, grads, _, _ = cs._zoo_small_step(NAME, dev, flat, batch)
        else:  # the kernels' dk doubled by the phase's own fault
            loss, grads, _, _ = cs._zoo_small_step(NAME, dev, flat, batch,
                                                   fault="dk" if doubled else None)
    for h in hooks:
        h.remove()
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(loss=loss, grads=grads, calls=calls, out_grads=out_grads)


def main() -> int:
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset
    from ppmstereo_tpu_torch.train.trainer import TrainConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "dk_trace.json"))
    args = ap.parse_args()

    _, _, smi = cs.phase_device()
    cs.phase_build()
    torch.set_num_threads(8)
    frames, h, w = cs.ZOO_TRAIN_SMALL
    sample = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w,
                                    seed=1)[0]
    batch = {"left": sample["img"][None, :, 0], "right": sample["img"][None, :, 1],
             "disparity": sample["disp"][None, :, 0], "valid": sample["valid"][None, :, 0]}
    cfg = TrainConfig(model_name=NAME, sample_len=frames, train_iters=cs.ZOO_TRAIN_SMALL_ITERS,
                      mixed_precision=False)
    _, flat = cs._zoo_start(cfg, blends_on=True)
    # what the seed drew on this machine's torch and numpy: the clip and the
    # initialisation, as sums of absolute values
    drawn = dict(torch=torch.__version__, clip=float(sum(
                     np.abs(np.asarray(x, np.float64)).sum() for x in batch.values())),
                 params=float(sum(np.abs(v.astype(np.float64)).sum() for v in flat.values())))
    cs.log(f"dk_trace: torch {drawn['torch']}, numpy {np.__version__}, seeded clip "
           f"{drawn['clip']:.6f}, seeded parameters {drawn['params']:.6f}")

    ways = ("cpu", "cpu dk x2", "cuda plain", "cuda plain dk x2", "cuda kernels",
            "cuda kernels dk x2")
    runs = {way: run_way(way, flat, batch) for way in ways}
    ref = runs["cpu"]["grads"]
    significant = cs.significant(ref)
    top = max(float(g.abs().max()) for g in ref.values())
    report = {"device": smi, "tensor": TENSOR, "drawn": drawn,
              "tensor_max_over_model_max": float(ref[TENSOR].abs().max()) / top,
              "significant_at": cs.SIGNIFICANT_GRAD, "tensor_significant": TENSOR in significant,
              "ways": {}}
    for way, run in runs.items():
        g = run["grads"]
        reading = cs.grad_agreement(g, ref, cs.ZOO_ENCODERS)
        report["ways"][way] = dict(
            loss=run["loss"], tensor_norm=float(g[TENSOR].norm()),
            tensor_vs_cpu=float((g[TENSOR] - ref[TENSOR]).norm() / ref[TENSOR].norm()),
            worst_tensor=reading["tensor"], calls=run["calls"], qk_output_grads=run["out_grads"])
        cs.log(f"dk_trace {way}: loss {run['loss']:.6f}, |grad {TENSOR}| "
               f"{float(g[TENSOR].norm()):.4e}, against the CPU's "
               f"{report['ways'][way]['tensor_vs_cpu']:.3e}; worst tensor {reading['tensor']}; "
               f"{len(run['calls'])} backward calls {run['calls']}; att_0 output grads "
               f"{run['out_grads']}")
    cs.log(f"dk_trace: {TENSOR} max |grad| / model max {report['tensor_max_over_model_max']:.3e} "
           f"(significant at {cs.SIGNIFICANT_GRAD}: {report['tensor_significant']}), on {smi}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
