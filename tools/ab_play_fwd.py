#!/usr/bin/env python3
"""Compare the play attention's forward kernels of two checkouts on one card.

    python3 tools/ab_play_fwd.py PARENT_DIR CHANGE_DIR

Each directory holds a `ppmstereo_tpu_torch/` package (a checkout, or an
unpacked `git archive` of one). In the order parent, change, change, parent
a fresh process imports that directory's package, builds its kernels from
its sources (into that directory's `build/`), runs kernel 1
(`play_attention`) and kernel 2 (`play_attention_fwd_res`) at the play
shapes of `chip_smoke.py`, and kernel 5 (`play_attention_carry`, one ring
hop) at the 2-way ring's hop shape of each (half the queries over half the
keys) from the empty state and from the state a plain hop over the other
half left, on the same seeded inputs; it saves the outputs and times each
kernel with CUDA events (kernel 5 at the three stage shapes). Then:

  * the two runs of one checkout must agree bit for bit (`torch.equal`):
    the kernels use no atomics, so a run is deterministic;
  * the change's outputs are held against the parent's with the limits of
    `chip_smoke.py`'s kernel checks, since a change may sum in another
    order: o within 2^-7 max|o| + 2^-8 max|v| (max) and 2^-8 mean|o|
    (mean), lse within 2^-12 (max) and 2^-16 (mean); kernel 5's o within
    2^-7 max|o| + 2^-8 max(l) max|v| and 2^-8 mean|o|, m within 2^-12 and
    2^-16, l within 2^-16 max l and 2^-18 mean l; whether they are
    bit-equal is reported;

and the times of the runs
are printed side by side. The last line of the output is a JSON summary,
also written to `chiprun_out/ab_play_fwd.json`. Exits non-zero when an
output fails a check.
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
CARRY_TIMED = ("1/4", "1/8", "1/16")


def child(root: str, out_path: str) -> None:
    """Run both kernels of the package under `root`; save outputs and times."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    if not Path(pa.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pa.__file__}, not the package under {root}")
    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    outs, times = {}, {}
    for label, b, lq, lk in SHAPES:
        q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
        k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
        v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
        o_res, lse = pa.play_attention_fwd_res(q, k, v, scale)
        outs[label] = dict(fwd=pa.play_attention(q, k, v, scale).cpu(), fwd_res=o_res.cpu(),
                           lse=lse.cpu(), v_max=v.float().abs().max().cpu())
        reps = 3 if lq * lk > 1e8 else 20
        times[label] = {name: _time_ms(fn, reps) for name, fn in (
            ("fwd", lambda: pa.play_attention(q, k, v, scale)),
            ("fwd_res", lambda: pa.play_attention_fwd_res(q, k, v, scale)))}
        # kernel 5 at the 2-way ring's hop shape, from the empty state and
        # from the state a hop over the other half of the keys left
        hq, hk = max(lq // 2, 1), max(lk // 2, 1)
        qh, kh, vh = q[:, :hq].contiguous(), k[:, :hk].contiguous(), v[:, :hk].contiguous()
        incoming = pa.play_attention_carry_plain(qh, k[:, hk:2 * hk].contiguous(),
                                                 v[:, hk:2 * hk].contiguous(), *_empty(b, hq),
                                                 scale)
        for state, name in ((_empty(b, hq), "carry_empty"),
                            (tuple(x.clone() for x in incoming), "carry_second")):
            co, cm, cl = pa.play_attention_carry(qh, kh, vh, *state, scale)
            outs[label].update({f"{name}_o": co.cpu(), f"{name}_m": cm.cpu(),
                                f"{name}_l": cl.cpu()})
        outs[label]["vh_max"] = vh.float().abs().max().cpu()
        if label in CARRY_TIMED:
            state = _empty(b, hq)
            times[label]["carry"] = _time_ms(lambda: pa.play_attention_carry(qh, kh, vh, *state,
                                                                             scale), reps + 2)
        del q, k, v, o_res, lse, qh, kh, vh, incoming
        torch.cuda.empty_cache()
    torch.save(dict(outs=outs, times=times), out_path)


def _empty(b: int, lq: int):
    """The ring's starting state (0, -1e30, 0) for B x Lq query rows."""
    import torch

    return (torch.zeros(b, lq, 128, device="cuda"), torch.full((b, lq), -1e30, device="cuda"),
            torch.zeros(b, lq, device="cuda"))


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
    deterministic = {f"{i} {which}": all(torch.equal(t, first[which][label][name])
                                         for label, outs in run["outs"].items()
                                         for name, t in outs.items())
                     for i, (which, run) in enumerate(runs)}
    agreement = {label: _agreement(first["change"][label], first["parent"][label])
                 for label, *_ in SHAPES}
    times = {label: {name: [run["times"][label][name] for _, run in runs]
                     for name in runs[0][1]["times"][label]} for label, *_ in SHAPES}
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
    print(f"each checkout's two runs bit-equal: {all_deterministic}; the change within the "
          f"limits of the parent: {all_agree}")
    summary = dict(card=smi, order=ORDER, times_ms=times, deterministic=deterministic,
                   agreement=agreement, all_deterministic=all_deterministic, all_agree=all_agree)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_play_fwd.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(dict(all_deterministic=all_deterministic, all_agree=all_agree,
                          times_ms=times)))
    return 0 if all_deterministic and all_agree else 1


def _agreement(change: dict, parent: dict) -> dict:
    """The change's o (kernels 1 and 2), lse and kernel 5's state against the
    parent's at one shape, each with chip_smoke.py's max and mean limits;
    kernel 2's o must also equal kernel 1's bit for bit within the change."""
    o = parent["fwd"].float().abs()
    o_limits = (2**-7 * o.max().item() + 2**-8 * parent["v_max"].item(), 2**-8 * o.mean().item())
    out = {}
    for name, (max_tol, mean_tol) in (("fwd", o_limits), ("fwd_res", o_limits),
                                      ("lse", (2**-12, 2**-16))):
        got = change[name].float()
        diff = (got - parent[name].float()).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        out[name] = dict(max_abs_err=err, tol=max_tol, mean_abs_err=mean_err, mean_tol=mean_tol,
                         bit_equal=bool(change[name].equal(parent[name])),
                         ok=bool(got.isfinite().all()) and err <= max_tol and mean_err <= mean_tol)
    out["fwd_res"]["ok"] &= bool(change["fwd_res"].equal(change["fwd"]))
    v_max = parent["vh_max"].item()
    for name in ("carry_empty", "carry_second"):
        po, pl = parent[f"{name}_o"].abs(), parent[f"{name}_l"]
        for part, (max_tol, mean_tol) in (
                ("o", (2**-7 * po.max().item() + 2**-8 * pl.max().item() * v_max,
                       2**-8 * po.mean().item())),
                ("m", (2**-12, 2**-16)),
                ("l", (2**-16 * pl.max().item(), 2**-18 * pl.mean().item()))):
            got, want = change[f"{name}_{part}"], parent[f"{name}_{part}"]
            diff = (got - want).abs()
            err, mean_err = diff.max().item(), diff.mean().item()
            out[f"{name}_{part}"] = dict(
                max_abs_err=err, tol=max_tol, mean_abs_err=mean_err, mean_tol=mean_tol,
                bit_equal=bool(got.equal(want)),
                ok=bool(got.isfinite().all()) and err <= max_tol and mean_err <= mean_tol)
    return out

if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2]))
