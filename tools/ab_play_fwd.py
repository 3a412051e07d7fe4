#!/usr/bin/env python3
"""Compare the play attention's forward kernels of two checkouts on one card.

    python3 tools/ab_play_fwd.py PARENT_DIR CHANGE_DIR

Each directory holds a `ppmstereo_tpu_torch/` package (a checkout, or an
unpacked `git archive` of one). In the order parent, change, change, parent
a fresh process imports that directory's package, builds its kernels from
its sources (into that directory's `build/`), runs kernel 1
(`play_attention`) and kernel 2 (`play_attention_fwd_res`) at the play
shapes of `chip_smoke.py` on the same seeded inputs, saves the outputs and
times each kernel with CUDA events. The outputs of every run are then held
against the first parent run's bit for bit (`torch.equal`), and the times
are printed side by side. The last line of the output is a JSON summary,
also written to `chiprun_out/ab_play_fwd.json`. Exits non-zero when an
output differs.
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
)
ORDER = ("parent", "change", "change", "parent")


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
                           lse=lse.cpu())
        reps = 3 if lq * lk > 1e8 else 20
        times[label] = {name: _time_ms(fn, reps) for name, fn in (
            ("fwd", lambda: pa.play_attention(q, k, v, scale)),
            ("fwd_res", lambda: pa.play_attention_fwd_res(q, k, v, scale)))}
        del q, k, v, o_res, lse
        torch.cuda.empty_cache()
    torch.save(dict(outs=outs, times=times), out_path)


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
    ref = runs[0][1]["outs"]
    equal = {f"{i} {which}": {label: {name: bool(torch.equal(t, ref[label][name]))
                                      for name, t in outs.items()}
                              for label, outs in run["outs"].items()}
             for i, (which, run) in enumerate(runs)}
    times = {label: {name: [run["times"][label][name] for _, run in runs]
                     for name in ("fwd", "fwd_res")} for label, *_ in SHAPES}
    print(f"card: {smi}; runs in order {', '.join(ORDER)}")
    for label, by_name in times.items():
        print(f"{label}: " + "; ".join(f"{name} " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
                                       for name, ts in by_name.items()))
    all_equal = all(v for run in equal.values() for shape in run.values() for v in shape.values())
    print(f"every output of every run bit-equal to the first parent run's: {all_equal}")
    summary = dict(card=smi, order=ORDER, times_ms=times, bit_equal=equal, all_equal=all_equal)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_play_fwd.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(dict(all_equal=all_equal, times_ms=times)))
    return 0 if all_equal else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2]))
