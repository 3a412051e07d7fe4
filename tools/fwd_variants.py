#!/usr/bin/env python3
"""Compare edited copies of the forward play kernel (kernels 1 and 2) on one card.

    python3 tools/fwd_variants.py [VARIANT ...]

Each variant is `ppmstereo_tpu_torch/csrc/play_attention_fwd.cu` and the
headers it includes (`csrc/*.cuh`) with a few text edits (VARIANTS below; no
argument runs them all, "committed" is the source as it stands). Every
variant is compiled by its own nvcc, all at once, with the flags of
`kernels/_build.py`, into `build/fwd_variants/<variant>/`; the script
prints each one's ptxas lines (registers, spills, C75xx remarks) and the
highest register, HGMMA, UTMALDG and local-memory instructions of its SASS,
loads it with ctypes and holds its kernels 1 and 2 against the plain version
at chip_smoke.py's play shapes and limits (kernel 2's o bit-equal to kernel
1's). Then it times kernel 1 of every variant that passed, and SDPA's
forward, at the three stage shapes with CUDA events, in two rounds of
opposite order. The last line is a JSON summary. Exits non-zero when a
variant fails.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ppmstereo_tpu_torch.kernels import _build  # noqa: E402
from ppmstereo_tpu_torch.kernels import play_attention as pa  # noqa: E402

SOURCE = _build.CSRC / "play_attention_fwd.cu"
OUT = REPO / "build" / "fwd_variants"

# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "committed": [],
    # a timed-out barrier wait traps instead of aborting the block
    "trap_in_waits": [(
        "    if (global_ns() - t0 > WAIT_LIMIT_NS) {\n"
        "      asm volatile(\"st.volatile.shared.u32 [%0], %1;\\n\" ::\"r\"(abort_flag), \"r\"(1u));\n"
        "      return;\n"
        "    }\n",
        "    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();\n")],
    "three_stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    # the consumer warpgroups take turns at the tensor cores (named barriers
    # 1 and 2): each waits for its turn before starting its products and hands
    # the turn on after committing them; consumer 0 goes first
    "ping_pong": [
        ("template <int MODE>\n__global__",
         "__device__ __forceinline__ void turn_wait(int c) {\n"
         "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(1 + c) : \"memory\");\n}\n"
         "__device__ __forceinline__ void turn_pass(int c) {\n"
         "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(1 + c) : \"memory\");\n}\n\n"
         "template <int MODE>\n__global__"),
        ("    float alpha[2];\n",
         "    float alpha[2];\n    const int c = wg - 1;\n    if (c == 1) turn_pass(0);\n"),
        ("    pin(s);\n    wgmma_fence();\n    mma_rows_dot_rows(s, desc_q, BOX_BYTES, desc_k, BOX_BYTES);\n    wgmma_commit();\n",
         "    turn_wait(c);\n    pin(s);\n    wgmma_fence();\n    mma_rows_dot_rows(s, desc_q, BOX_BYTES, desc_k, BOX_BYTES);\n"
         "    wgmma_commit();\n    turn_pass(1 - c);\n"),
        ("      pin(s);\n      pin(o);\n      pin(p);\n      wgmma_fence();\n",
         "      turn_wait(c);\n      pin(s);\n      pin(o);\n      pin(p);\n      wgmma_fence();\n"),
        ("      mma_regs_times_rows(o, p, desc_v + prev * STAGE_STEP);  // O += P_{j-1} V_{j-1}\n"
         "      wgmma_commit();\n",
         "      mma_regs_times_rows(o, p, desc_v + prev * STAGE_STEP);  // O += P_{j-1} V_{j-1}\n"
         "      wgmma_commit();\n      turn_pass(1 - c);\n"),
        ("    pin(o);\n    pin(p);\n    wgmma_fence();\n    mma_regs_times_rows(o, p, desc_v + last * STAGE_STEP);\n"
         "    wgmma_commit();\n",
         "    turn_wait(c);\n    pin(o);\n    pin(p);\n    wgmma_fence();\n"
         "    mma_regs_times_rows(o, p, desc_v + last * STAGE_STEP);\n    wgmma_commit();\n"
         "    if (c == 0) turn_pass(1);\n")],
}
# (label, rows B, Lq, Lk): chip_smoke.py's PLAY_SHAPES
SHAPES = (
    ("1/4", 10, 80 * 128, 5 * 80 * 128),
    ("1/8", 10, 40 * 64, 5 * 40 * 64),
    ("1/16", 10, 20 * 32, 5 * 20 * 32),
    ("unaligned", 3, 1000, 4999),
    ("tiny", 1, 17, 5),
    ("odd", 2, 65, 129),
)
TIMED = ("1/4", "1/8", "1/16")


def edited_sources(name: str, source: Path = SOURCE, variants: dict = VARIANTS) -> dict:
    """{file name: text} of `source` and every csrc/*.cuh header with the
    variant's edits applied, each to the one file that holds its text once."""
    files = {f.name: f.read_text() for f in [source, *sorted(_build.CSRC.glob("*.cuh"))]}
    for old, new in variants[name]:
        holders = [f for f, text in files.items() if text.count(old) == 1]
        if len(holders) != 1 or sum(text.count(old) for text in files.values()) != 1:
            raise ValueError(f"variant {name}: the edit's text is not found once in "
                             f"{source.name} and the headers")
        files[holders[0]] = files[holders[0]].replace(old, new)
    return files


def compile_variant(name: str, source: Path = SOURCE, variants: dict = VARIANTS,
                    out: Path = OUT) -> dict:
    """Write the variant's `edited_sources` into out/<name>/, compile its
    copy of `source` with the flags of kernels/_build.py and read its ptxas
    lines and SASS."""
    folder = out / name
    folder.mkdir(parents=True, exist_ok=True)
    files = edited_sources(name, source, variants)
    for fname, text in files.items():
        (folder / fname).write_text(text)
    path = folder / source.name
    lib = folder / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}{proc.stderr}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if any(w in line for w in ("registers", "spill", "C75"))]
    return dict(lib=lib, ptxas=ptxas, max_register=max(int(r) for r in re.findall(r"\bR(\d+)\b", sass)),
                **{op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "STL", "LDL")})


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    for name in ("play_attention_fwd", "play_attention_fwd_res"):
        fn = getattr(lib, name)
        fn.argtypes = pa._ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def run(lib, q, k, v, scale: float, with_lse: bool = False):
    import torch

    b, lq, _ = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if with_lse:
        lse = torch.empty(b, lq, device=q.device)
        err = lib.play_attention_fwd_res(*args, lse.data_ptr(), b, lq, k.shape[1], scale * pa.LOG2E,
                                         stream)
    else:
        err = lib.play_attention_fwd(*args, b, lq, k.shape[1], scale * pa.LOG2E, stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return (out, lse) if with_lse else out


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(names: list) -> int:
    import torch
    import torch.nn.functional as F

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(compile_variant, names)))
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
        ref, ref_lse = pa.play_attention_fwd_res_plain(q, k, v, scale)
        o_tol = 2**-7 * ref.float().abs().max().item() + 2**-8 * v.float().abs().max().item()
        o_mean_tol = 2**-8 * ref.float().abs().mean().item()
        for name, lib in libs.items():
            o = run(lib, q, k, v, scale)
            o_res, lse = run(lib, q, k, v, scale, with_lse=True)
            torch.cuda.synchronize()
            diff = (o.float() - ref.float()).abs()
            c = dict(max_abs_err=diff.max().item(), tol=o_tol, mean_abs_err=diff.mean().item(),
                     mean_tol=o_mean_tol, lse_max_abs_err=(lse - ref_lse).abs().max().item(),
                     o_bit_equal_kernel_1=bool(torch.equal(o, o_res)))
            c["ok"] = (c["max_abs_err"] <= o_tol and c["mean_abs_err"] <= o_mean_tol
                       and c["lse_max_abs_err"] <= 2**-12 and c["o_bit_equal_kernel_1"])
            checks[name][label] = c
            passed[name] &= c["ok"]
            print(f"{name} {label}: o max {c['max_abs_err']:.3e} (tol {o_tol:.3e}) mean "
                  f"{c['mean_abs_err']:.3e} (tol {o_mean_tol:.3e}), lse max "
                  f"{c['lse_max_abs_err']:.3e}, kernel 2's o equal {c['o_bit_equal_kernel_1']}: "
                  f"{'ok' if c['ok'] else 'FAILED'}", flush=True)
        if label in TIMED:
            fns = {name: (lambda lib=lib: run(lib, q, k, v, scale)) for name, lib in libs.items()
                   if passed[name]}
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                                                 scale=scale)
            reps = 5 if lq * lk > 1e8 else 20
            ts = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    ts[name].append(time_ms(fns[name], reps))
            times[label] = ts
            flops = 4.0 * b * lq * lk * 128
            for name, t in ts.items():
                print(f"  {label} {name} on {smi}: " + ", ".join(f"{x:.3f}" for x in t)
                      + f" ms ({flops / min(t) / 1e9:.0f} TFLOP/s at the faster)", flush=True)
        del q, k, v, ref, ref_lse
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
