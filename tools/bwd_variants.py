#!/usr/bin/env python3
"""Compare edited copies of the backward play kernels (kernels 3 and 4) on one card.

    python3 tools/bwd_variants.py [VARIANT ...]

Each variant is `ppmstereo_tpu_torch/csrc/play_attention_bwd.cu` and the
headers it includes (`csrc/*.cuh`) with a few text edits (VARIANTS below; no
argument runs them all, "committed" is the source as it stands). Every
variant is compiled by its own nvcc, all at once, with the flags of
`kernels/_build.py`, into `build/bwd_variants/<variant>/`
(`tools/fwd_variants.py::compile_variant`); the script prints each one's
ptxas lines and the highest register, HGMMA, UTMALDG and local-memory
instructions of its SASS, loads it with ctypes and holds its dq, dk and dv
against the plain version at chip_smoke.py's play shapes and backward limits
(3 * 2^-8 max|ref| and 2^-7.5 mean|ref|), a second launch bit-equal to the
first ("probe_" variants leave work out on purpose and are timed without
being held to the checks). Then it times kernels 3 and 4 of every variant
that passed, and
SDPA's backward alone (one forward, then its backward over the reps), at
the three stage shapes with CUDA events, in two rounds of opposite order.
The last line is a JSON summary. Exits non-zero when a variant fails.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from fwd_variants import SHAPES, TIMED, compile_variant, time_ms  # noqa: E402

from ppmstereo_tpu_torch.kernels import _build  # noqa: E402
from ppmstereo_tpu_torch.kernels import play_attention as pa  # noqa: E402

SOURCE = _build.CSRC / "play_attention_bwd.cu"
OUT = REPO / "build" / "bwd_variants"

# the committed dk/dv tile's end: dK, the lagging dV's wait, P^T's packing
_DKV_TAIL = (
    "      pack_acc<32>(ds, dp);\n"
    "      pin(ds);\n"
    "      pin(acc_k);\n"
    "      wgmma_fence();\n"
    "      mma_regs_times_rows(acc_k, ds, desc_qt + st * STEP_64);  // dK += dS^T_j Q_j\n"
    "      wgmma_commit();\n"
    "      wgmma_wait<1>();  // dV of tile j - 1 is done: stage j - 1 is free\n"
    "      pin(acc_v);\n"
    "      pin(pp);\n"
    "      if (j > 0) mbar_arrive(bar_empty + 8 * prev);\n"
    "      pack_acc<32>(pp, s);  // P^T_j, for the next tile's dV\n"
    "      wgmma_wait<0>();\n"
    "      pin(acc_k);\n"
    "      pin(ds);\n"
    "    }\n"
    "    pin(pp);\n"
    "    pin(acc_v);\n"
    "    wgmma_fence();\n"
    "    mma_regs_times_rows(acc_v, pp, desc_dot + ((ntiles - 1) % DKV_STAGES) * STEP_64);\n"
    "    wgmma_commit();\n"
    "    wgmma_wait<0>();\n"
    "    pin(acc_v);\n"
    "    pin(pp);\n")
_DQ_TURNS = (
    "// ---------------------------------------------------------------- dq\n",
    # turn-taking of the two consumer warpgroups at the tensor cores (named
    # barriers 1 and 2, 256 threads: one group waits, the other arrives)
    "__device__ __forceinline__ void turn_wait(int c) {\n"
    "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(1 + c) : \"memory\");\n}\n"
    "__device__ __forceinline__ void turn_pass(int c) {\n"
    "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(1 + c) : \"memory\");\n}\n\n"
    "// ---------------------------------------------------------------- dq\n")

# name -> [(text in the source or a header, its replacement), ...]
VARIANTS = {
    "committed": [],
    # dk/dv without the lag: dV and dK of tile j both waited for at its end
    "dkv_no_lag": [
        ("      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1\n"
         "      wgmma_commit();\n", ""),
        ("      wgmma_wait<2>();  // S^T_j is done; dP^T_j and dV may still run\n",
         "      wgmma_wait<1>();  // S^T_j is done\n"),
        ("      wgmma_wait<1>();  // dP^T_j is done; dV may still run\n",
         "      wgmma_wait<0>();  // dP^T_j is done\n"),
        (_DKV_TAIL,
         "      pack_acc<32>(pp, s);\n      pack_acc<32>(ds, dp);\n      pin(pp);\n      pin(ds);\n"
         "      pin(acc_k);\n      pin(acc_v);\n      wgmma_fence();\n"
         "      mma_regs_times_rows(acc_v, pp, desc_dot + st * STEP_64);\n"
         "      mma_regs_times_rows(acc_k, ds, desc_qt + st * STEP_64);\n"
         "      wgmma_commit();\n      wgmma_wait<0>();\n"
         "      pin(acc_k);\n      pin(acc_v);\n      pin(pp);\n      pin(ds);\n"
         "      mbar_arrive(bar_empty + 8 * st);\n    }\n"),
    ],
    # dK lags one tile as well: committed with dV in the next tile's first
    # batch, so the packed dS^T stays in flight under that tile's arithmetic
    # (16 more registers)
    "dkv_dk_lag": [
        ("      pin(pp);\n      pin(acc_v);\n      wgmma_fence();\n      mma_rows_dot_rows(s, desc_k,",
         "      pin(pp);\n      pin(acc_v);\n      pin(ds);\n      pin(acc_k);\n      wgmma_fence();\n"
         "      mma_rows_dot_rows(s, desc_k,"),
        ("      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1\n",
         "      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1\n"
         "      if (j > 0) mma_regs_times_rows(acc_k, ds, desc_qt + prev * STEP_64);  // dK, tile j - 1\n"),
        ("      wgmma_wait<1>();  // dP^T_j is done; dV may still run\n",
         "      wgmma_wait<1>();  // dP^T_j is done; dV and dK may still run\n"),
        (_DKV_TAIL,
         "      wgmma_wait<0>();  // dV and dK of tile j - 1 are done: stage j - 1 is free\n"
         "      pin(acc_v);\n      pin(acc_k);\n      pin(pp);\n      pin(ds);\n"
         "      if (j > 0) mbar_arrive(bar_empty + 8 * prev);\n"
         "      pack_acc<32>(pp, s);\n      pack_acc<32>(ds, dp);\n    }\n"
         "    pin(pp);\n    pin(ds);\n    pin(acc_v);\n    pin(acc_k);\n    wgmma_fence();\n"
         "    mma_regs_times_rows(acc_v, pp, desc_dot + ((ntiles - 1) % DKV_STAGES) * STEP_64);\n"
         "    mma_regs_times_rows(acc_k, ds, desc_qt + ((ntiles - 1) % DKV_STAGES) * STEP_64);\n"
         "    wgmma_commit();\n    wgmma_wait<0>();\n"
         "    pin(acc_v);\n    pin(acc_k);\n    pin(pp);\n    pin(ds);\n"),
    ],
    # dq: each consumer waits for its turn before a batch of products (S_j,
    # dP_j and dQ += dS_{j-1} K_{j-1}) and hands the turn on after committing
    # it, so one group's exponentials run under the other's products;
    # consumer 0 goes first
    "dq_ping_pong": [
        _DQ_TURNS,
        ("    mbar_wait(bar_q, 0, abort_flag);\n    mbar_wait(bar_full, 0, abort_flag);\n"
         "    pin(s);\n",
         "    mbar_wait(bar_q, 0, abort_flag);\n    mbar_wait(bar_full, 0, abort_flag);\n"
         "    if (c == 1) turn_pass(0);\n    turn_wait(c);\n    pin(s);\n"),
        ("    mma_rows_dot_rows(dp, desc_do, BOX_128, desc_v, BOX_64);\n    wgmma_commit();\n",
         "    mma_rows_dot_rows(dp, desc_do, BOX_128, desc_v, BOX_64);\n    wgmma_commit();\n"
         "    turn_pass(1 - c);\n"),
        ("      mbar_wait(bar_full + 8 * st, (j / DQ_STAGES) & 1, abort_flag);\n      pin(s);\n",
         "      mbar_wait(bar_full + 8 * st, (j / DQ_STAGES) & 1, abort_flag);\n"
         "      turn_wait(c);\n      pin(s);\n"),
        ("      mma_regs_times_rows(acc, ds, desc_kt + prev * STEP_64);  // dQ += dS_{j-1} K_{j-1}\n"
         "      wgmma_commit();\n",
         "      mma_regs_times_rows(acc, ds, desc_kt + prev * STEP_64);  // dQ += dS_{j-1} K_{j-1}\n"
         "      wgmma_commit();\n      turn_pass(1 - c);\n"),
        ("    pin(ds);\n    pin(acc);\n    wgmma_fence();\n    mma_regs_times_rows(acc, ds, desc_kt + last",
         "    pin(ds);\n    pin(acc);\n    turn_wait(c);\n    wgmma_fence();\n"
         "    mma_regs_times_rows(acc, ds, desc_kt + last"),
        ("    mma_regs_times_rows(acc, ds, desc_kt + last * STEP_64);\n    wgmma_commit();\n",
         "    mma_regs_times_rows(acc, ds, desc_kt + last * STEP_64);\n    wgmma_commit();\n"
         "    if (c == 0) turn_pass(1);\n"),
    ],
    # dk/dv: the same turns for its two batches (S^T_j, dP^T_j and the
    # lagging dV; dK) and the last dV
    "dkv_ping_pong": [
        _DQ_TURNS,
        ("    mbar_wait(bar_kv, 0, abort_flag);\n    for (int j = 0; j < ntiles; ++j) {\n",
         "    mbar_wait(bar_kv, 0, abort_flag);\n    if (c == 1) turn_pass(0);\n"
         "    for (int j = 0; j < ntiles; ++j) {\n"),
        ("      mbar_wait(bar_full + 8 * st, (j / DKV_STAGES) & 1, abort_flag);\n      pin(s);\n",
         "      mbar_wait(bar_full + 8 * st, (j / DKV_STAGES) & 1, abort_flag);\n"
         "      turn_wait(c);\n      pin(s);\n"),
        ("      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1\n"
         "      wgmma_commit();\n",
         "      if (j > 0) mma_regs_times_rows(acc_v, pp, desc_dot + prev * STEP_64);  // dV, tile j - 1\n"
         "      wgmma_commit();\n      turn_pass(1 - c);\n"),
        ("      pin(acc_k);\n      wgmma_fence();\n      mma_regs_times_rows(acc_k, ds,",
         "      pin(acc_k);\n      turn_wait(c);\n      wgmma_fence();\n      mma_regs_times_rows(acc_k, ds,"),
        ("      mma_regs_times_rows(acc_k, ds, desc_qt + st * STEP_64);  // dK += dS^T_j Q_j\n"
         "      wgmma_commit();\n",
         "      mma_regs_times_rows(acc_k, ds, desc_qt + st * STEP_64);  // dK += dS^T_j Q_j\n"
         "      wgmma_commit();\n      turn_pass(1 - c);\n"),
        ("    pin(pp);\n    pin(acc_v);\n    wgmma_fence();\n",
         "    pin(pp);\n    pin(acc_v);\n    turn_wait(c);\n    wgmma_fence();\n"),
        ("    mma_regs_times_rows(acc_v, pp, desc_dot + ((ntiles - 1) % DKV_STAGES) * STEP_64);\n"
         "    wgmma_commit();\n",
         "    mma_regs_times_rows(acc_v, pp, desc_dot + ((ntiles - 1) % DKV_STAGES) * STEP_64);\n"
         "    wgmma_commit();\n    if (c == 0) turn_pass(1);\n"),
    ],
    "dkv_three_stages": [("constexpr int DKV_STAGES = 4;", "constexpr int DKV_STAGES = 3;")],
    "dq_five_stages": [("constexpr int DQ_STAGES = 4;", "constexpr int DQ_STAGES = 5;")],
    "two_stages": [("constexpr int DQ_STAGES = 4;", "constexpr int DQ_STAGES = 2;"),
                   ("constexpr int DKV_STAGES = 4;", "constexpr int DKV_STAGES = 2;")],
    # probes (timed, not checked: their outputs are wrong by design), each
    # leaving one part of the work out to show its share of the time
    "probe_no_exp2": [
        ("  for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_lse[(i >> 1) & 1]));",
         "  for (int i = 0; i < 32; ++i) s[i] = fmaf(s[i], scale_log2, neg_lse[(i >> 1) & 1]);"),
        ("          s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], scale_log2, -l2[e & 1]));",
         "          s[4 * i + e] = fmaf(s[4 * i + e], scale_log2, -l2[e & 1]);")],
    "probe_dkv_no_ss": [
        ("      mma_rows_dot_rows(s, desc_k, BOX_128, desc_q + st * STEP_64, BOX_64);  // S^T_j\n", ""),
        ("      mma_rows_dot_rows(dp, desc_v, BOX_128, desc_do + st * STEP_64, BOX_64);  // dP^T_j\n",
         "")],
}


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    for name in ("play_attention_bwd_dq", "play_attention_bwd_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = pa._ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def run_dq(lib, q, k, v, do, lse, di, scale: float):
    import torch

    b, lq, _ = q.shape
    dq = torch.empty_like(q)
    err = lib.play_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, lq,
                                    k.shape[1], scale * pa.LOG2E, scale,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dq launch failed: CUDA error {err}")
    return dq


def run_dkv(lib, q, k, v, do, lse, di, scale: float):
    import torch

    b, lq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.play_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                     lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                     b, lq, k.shape[1], scale * pa.LOG2E, scale,
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dk/dv launch failed: CUDA error {err}")
    return dk, dv


def main(names: list) -> int:
    import torch
    import torch.nn.functional as F

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: compile_variant(n, SOURCE, VARIANTS, OUT), names)))
    for name, info in built.items():
        print(f"{name}: SASS max register R{info['max_register']}, HGMMA {info['HGMMA']}, UTMALDG "
              f"{info['UTMALDG']}, STL {info['STL']}, LDL {info['LDL']}", flush=True)
        for line in info["ptxas"]:
            print(f"  {line[:200]}", flush=True)
    libs = {name: bind(info["lib"]) for name, info in built.items()}
    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    passed = dict.fromkeys(names, True)
    checks, times = {n: {} for n in names}, {label: {} for label in TIMED}
    for label, b, lq, lk in SHAPES:
        q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
        k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
        v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, lq, 128, generator=gen, device="cuda").bfloat16()
        o, lse = pa.play_attention_fwd_res_plain(q, k, v, scale)
        di = pa.play_attention_di(o, do)
        refs = dict(zip(("dq", "dk", "dv"), pa.play_attention_bwd_plain(q, k, v, do, scale)))
        for name, lib in libs.items():
            grads = [dict(zip(("dq", "dk", "dv"), (run_dq(lib, q, k, v, do, lse, di, scale),
                                                   *run_dkv(lib, q, k, v, do, lse, di, scale))))
                     for _ in range(2)]
            torch.cuda.synchronize()
            c = {}
            probe = name.startswith("probe_")
            for out, ref in refs.items():
                r = ref.float()
                diff = (grads[0][out].float() - r).abs()
                c[out] = dict(max_abs_err=diff.max().item(), tol=3 * 2**-8 * r.abs().max().item(),
                              mean_abs_err=diff.mean().item(),
                              mean_tol=2**-7.5 * r.abs().mean().item(),
                              bit_equal_rerun=bool(torch.equal(grads[0][out], grads[1][out])))
                c[out]["ok"] = (bool(grads[0][out].isfinite().all())
                                and c[out]["max_abs_err"] <= c[out]["tol"]
                                and c[out]["mean_abs_err"] <= c[out]["mean_tol"]
                                and c[out]["bit_equal_rerun"])
                passed[name] &= c[out]["ok"] or probe
            checks[name][label] = c
            print(f"{name} {label}: " + "; ".join(
                f"{out} max {x['max_abs_err']:.3e} (tol {x['tol']:.3e}) mean "
                f"{x['mean_abs_err']:.3e} (tol {x['mean_tol']:.3e}) rerun equal "
                f"{x['bit_equal_rerun']}" for out, x in c.items())
                + f": {'ok' if all(x['ok'] for x in c.values()) else 'FAILED'}"
                + (" (a probe: not held to the limits)" if probe else ""), flush=True)
        if label in TIMED:
            fns = {}
            for name, lib in libs.items():
                if passed[name]:
                    fns[f"{name} dq"] = lambda lib=lib: run_dq(lib, q, k, v, do, lse, di, scale)
                    fns[f"{name} dkv"] = lambda lib=lib: run_dkv(lib, q, k, v, do, lse, di, scale)
            qg, kg, vg = (x[:, None].detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

            def sdpa_bwd():
                qg.grad = kg.grad = vg.grad = None
                sdpa_out.backward(do[:, None], retain_graph=True)

            fns["sdpa backward"] = sdpa_bwd
            reps = 5 if lq * lk > 1e8 else 20
            ts = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    ts[name].append(time_ms(fns[name], reps))
            times[label] = ts
            for name, t in ts.items():
                print(f"  {label} {name} on {smi}: " + ", ".join(f"{x:.3f}" for x in t) + " ms",
                      flush=True)
            del qg, kg, vg, sdpa_out
        del q, k, v, do, o, lse, di, refs
        torch.cuda.empty_cache()
    builds = {n: {k: v for k, v in i.items() if k != "lib"} for n, i in built.items()}
    print(json.dumps(dict(card=smi, builds=builds, checks=checks, times_ms=times, passed=passed)))
    return 0 if all(passed.values()) else 1


if __name__ == "__main__":
    chosen = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in chosen if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sys.exit(main(chosen))
