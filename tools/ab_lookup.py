#!/usr/bin/env python3
"""Compare the pyramid lookup (kernel 6) of two checkouts on one card.

    python3 tools/ab_lookup.py PARENT_DIR CHANGE_DIR

Each directory holds a `ppmstereo_tpu_torch/` package (a checkout, or an
unpacked `git archive` of one). In the order parent, change, change, parent
a fresh process imports that directory's package, builds its lookup from
its sources (into that directory's `build/`) and calls its wrapper,
`kernels/corr_lookup.py::corr_lookup_kernel`, at the three stages' pyramids
of `chip_smoke.py` (the same seeded inputs in every run): f32 in and out,
which every version takes, and bf16 in and out, the main path's, where the
version takes it. Whether each output equals the plain lookup
(`ops/corr.py::corr_lookup`, cast) bit for bit is reported; the change's
must. Two times per call, each
over REPS back-to-back calls after a warm-up:

  * host_us: the host's time to issue one call (`time.perf_counter`
    around the calls, stopped before the closing synchronize), which is
    what a call costs the host-bound model;
  * event_us: CUDA events around the same calls: the larger of the host's
    issue time and the kernel's device time.

The last line of the output is a JSON summary, also written to
`chiprun_out/ab_lookup.json`. Exits non-zero when an output of the
change is not bit-equal.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (label, N, H, W1, W2): chip_smoke.py's LOOKUP_SHAPES at the three stages
SHAPES = (("1/4", 10, 80, 128, 128), ("1/8", 10, 40, 64, 64), ("1/16", 10, 20, 32, 32))
DTYPES = ("float32", "bfloat16")  # pyramid and output of one run
ORDER = ("parent", "change", "change", "parent")
REPS = 200


def child(root: str, out_path: str) -> None:
    """Call the lookup of the package under `root`; save checks and times."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup

    if not Path(kl.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {kl.__file__}, not the package under {root}")
    takes_dtype = "out_dtype" in inspect.signature(kl.corr_lookup_kernel).parameters
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for label, n, h, w1, w2 in SHAPES:
        f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
        f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
        pyr32 = [c.reshape(n, h, w1, -1).contiguous() for c in build_corr_pyramid(f1, f2, 4)]
        cols = torch.arange(w1, device="cuda", dtype=torch.float32)
        coords = cols - torch.rand(n, h, w1, generator=gen, device="cuda") * 0.4 * w2
        for name in DTYPES:
            dtype = getattr(torch, name)
            if dtype != torch.float32 and not takes_dtype:
                continue
            pyramid = [c.to(dtype) for c in pyr32]
            kwargs = {"out_dtype": dtype} if takes_dtype else {}

            def call(pyramid=pyramid, kwargs=kwargs):
                return kl.corr_lookup_kernel(pyramid, coords, **kwargs)

            got = call()
            want = corr_lookup(pyramid, coords).to(dtype)
            torch.cuda.synchronize()
            results[f"{label} {name}"] = dict(bit_equal=bool(torch.equal(got, want)),
                                              **_per_call_us(call))
    torch.save(results, out_path)


def _per_call_us(fn) -> dict:
    """Microseconds per call of fn over REPS back-to-back calls: the host's
    issue time and the CUDA-event time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return dict(host_us=host_s / REPS * 1e6, event_us=start.elapsed_time(end) / REPS * 1e3)


def summarise(runs: list) -> tuple[dict, bool]:
    """The runs' times side by side, per case ("1/4 float32", ...) and
    checkout ("parent host_us": one entry a run, in the order of `runs`;
    none where that version does not take the case), and per checkout
    whether every output of its runs was bit-equal."""
    cases = list(dict.fromkeys(case for _, run in runs for case in run))
    times = {case: {f"{which} {t}": [run[case][t] for w, run in runs
                                     if w == which and case in run]
                    for which in dict.fromkeys(w for w, _ in runs)
                    for t in ("host_us", "event_us")} for case in cases}
    bit_equal = {which: all(r["bit_equal"] for w, run in runs if w == which
                            for r in run.values()) for which in dict.fromkeys(w for w, _ in runs)}
    return times, bit_equal


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
                           check=True, timeout=600)
            runs.append((which, torch.load(path)))
    times, bit_equal = summarise(runs)
    print(f"card: {smi}; runs in order {', '.join(ORDER)}; microseconds per call over {REPS} "
          "calls")
    for case, by_key in times.items():
        print(f"{case}: " + "; ".join(f"{key} " + ", ".join(f"{t:.2f}" for t in ts)
                                      for key, ts in by_key.items() if ts))
    print(f"every output bit-equal to the plain lookup, per checkout: {bit_equal}")
    summary = dict(card=smi, order=ORDER, reps=REPS, times_us=times, bit_equal=bit_equal)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_lookup.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0 if bit_equal["change"] else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2]))
