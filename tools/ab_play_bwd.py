#!/usr/bin/env python3
"""Compare the play attention's backward kernels of two checkouts on one card.

    python3 tools/ab_play_bwd.py PARENT_DIR CHANGE_DIR

Each directory holds a `ppmstereo_tpu_torch/` package (a checkout, or an
unpacked `git archive` of one). In the order parent, change, change, parent
a fresh process imports that directory's package, builds its kernels from
its sources (into that directory's `build/`), makes o and lse with the plain
forward and Di = rowsum(dO o O) in f32 (the same for both checkouts), runs
kernel 3 (`play_attention_bwd_dq`) and kernel 4 (`play_attention_bwd_dkv`)
twice at the play shapes of `chip_smoke.py` on the same seeded inputs, saves
the outputs and times each kernel, and SDPA's backward alone (one forward,
then its backward over the reps), with CUDA events. Then:

  * each run's two launches, and the two runs of one checkout, must agree
    bit for bit (`torch.equal`): the kernels use no atomics;
  * the change's dq, dk and dv are held against the parent's with the
    limits of `chip_smoke.py`'s backward checks, since a change may sum in
    another order: 3 * 2^-8 max|parent| (max) and 2^-7.5 mean|parent|
    (mean); whether they are bit-equal is reported;

and the times of the runs are printed side by side. The last line of the
output is a JSON summary, also written to `chiprun_out/ab_play_bwd.json`.
Exits non-zero when an output fails a check.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

# (label, rows B, Lq, Lk): chip_smoke.py's PLAY_SHAPES
SHAPES = (
    ("1/4", 10, 80 * 128, 5 * 80 * 128),
    ("1/8", 10, 40 * 64, 5 * 40 * 64),
    ("1/16", 10, 20 * 32, 5 * 20 * 32),
    ("unaligned", 3, 1000, 4999),
    ("tiny", 1, 17, 5),
    ("odd", 2, 65, 129),
)
ORDER = ("parent", "change", "change", "parent")
OUTPUTS = ("dq", "dk", "dv")
TIMES = ("dq", "dkv", "sdpa_bwd")


def child(root: str, out_path: str) -> None:
    """Run both kernels of the package under `root`; save outputs and times."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import torch.nn.functional as F

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    if not Path(pa.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pa.__file__}, not the package under {root}")
    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    outs, times, rerun_equal = {}, {}, {}
    for label, b, lq, lk in SHAPES:
        q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
        k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
        v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, lq, 128, generator=gen, device="cuda").bfloat16()
        o, lse = pa.play_attention_fwd_res_plain(q, k, v, scale)
        di = (do.float() * o.float()).sum(dim=-1)

        def grads():
            dq = pa.play_attention_bwd_dq(q, k, v, do, lse, di, scale)
            return (dq, *pa.play_attention_bwd_dkv(q, k, v, do, lse, di, scale))

        first, second = grads(), grads()
        rerun_equal[label] = all(torch.equal(x, y) for x, y in zip(first, second))
        outs[label] = {name: x.cpu() for name, x in zip(OUTPUTS, first)}
        qg, kg, vg = (x[:, None].detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

        def sdpa_bwd():
            qg.grad = kg.grad = vg.grad = None
            sdpa_out.backward(do[:, None], retain_graph=True)

        reps = 3 if lq * lk > 1e8 else 20
        times[label] = {name: _time_ms(fn, reps) for name, fn in (
            ("dq", lambda: pa.play_attention_bwd_dq(q, k, v, do, lse, di, scale)),
            ("dkv", lambda: pa.play_attention_bwd_dkv(q, k, v, do, lse, di, scale)),
            ("sdpa_bwd", sdpa_bwd))}
        del q, k, v, do, o, lse, di, first, second, qg, kg, vg, sdpa_out
        torch.cuda.empty_cache()
    torch.save(dict(outs=outs, times=times, rerun_equal=rerun_equal), out_path)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(parent: str, change: str) -> int:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    roots = {"parent": parent, "change": change}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate(ORDER):
            path = Path(tmp) / f"{i}_{which}.pt"
            subprocess.run([sys.executable, __file__, "--child", roots[which], str(path)],
                           check=True, timeout=900)
            runs.append((which, torch.load(path)))
    first = {}  # each checkout's first run
    for which, run in runs:
        first.setdefault(which, run["outs"])
    deterministic = {f"{i} {which}": all(run["rerun_equal"].values()) and all(
        torch.equal(t, first[which][label][name])
        for label, outs in run["outs"].items() for name, t in outs.items())
        for i, (which, run) in enumerate(runs)}
    agreement = {label: _agreement(first["change"][label], first["parent"][label])
                 for label, *_ in SHAPES}
    times = {label: {name: [run["times"][label][name] for _, run in runs] for name in TIMES}
             for label, *_ in SHAPES}
    print(f"card: {smi}; runs in order {', '.join(ORDER)}")
    for label, by_name in times.items():
        print(f"{label}: " + "; ".join(f"{name} " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
                                       for name, ts in by_name.items()))
        print("  change vs parent: " + "; ".join(
            f"{name} max {c['max_abs_err']:.3e} (tol {c['tol']:.3e}) mean "
            f"{c['mean_abs_err']:.3e} (tol {c['mean_tol']:.3e}) bit-equal {c['bit_equal']}"
            for name, c in agreement[label].items()))
    all_deterministic = all(deterministic.values())
    all_agree = all(c["ok"] for by_name in agreement.values() for c in by_name.values())
    print(f"each checkout's launches and runs bit-equal: {all_deterministic}; the change within "
          f"the limits of the parent: {all_agree}")
    summary = dict(card=smi, order=ORDER, times_ms=times, deterministic=deterministic,
                   agreement=agreement, all_deterministic=all_deterministic, all_agree=all_agree)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_play_bwd.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(dict(all_deterministic=all_deterministic, all_agree=all_agree,
                          times_ms=times)))
    return 0 if all_deterministic and all_agree else 1


def _agreement(change: dict, parent: dict) -> dict:
    """The change's dq, dk and dv against the parent's at one shape, each
    with chip_smoke.py's backward limits."""
    out = {}
    for name in OUTPUTS:
        want = parent[name].float()
        got = change[name].float()
        diff = (got - want).abs()
        max_tol, mean_tol = 3 * 2**-8 * want.abs().max().item(), 2**-7.5 * want.abs().mean().item()
        err, mean_err = diff.max().item(), diff.mean().item()
        out[name] = dict(max_abs_err=err, tol=max_tol, mean_abs_err=mean_err, mean_tol=mean_tol,
                         bit_equal=bool(change[name].equal(parent[name])),
                         ok=bool(got.isfinite().all()) and err <= max_tol and mean_err <= mean_tol)
    return out


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2]))
