#!/usr/bin/env python3
"""How the port's f32 convolutions run on one card with cuDNN's heuristic
algorithm choice and under `utils/device.py::cudnn_autotune` (benchmark
mode), each in a process of its own (PyTorch caches a convolution's plan by
its shapes, whichever way it was chosen).

    python3 tools/f32_convs.py [--out chiprun_out/f32_convs.json]

In each mode:
  * conv: the largest f32 convolution of RAFT-Stereo's encoders (64 -> 64,
    3x3, on 20 images at 320x512) and the first stage of its 1/4 GRU
    (384 -> 128, 3x3, 10 x 80 x 128), each given to F.conv2d as the
    channels-last view `nn/common.py::ConvND` passes and as a contiguous
    NCHW tensor; milliseconds (CUDA events), peak memory above the input on
    the first call (an algorithm search's included), the top kernels under
    torch.profiler, and the largest |difference| from the first layout;
  * window: one RAFTStereoModel window of 10 frames at 320x512 (f32, 32
    iterations, seeded weights): the first and the second call's seconds and
    peak memory (in heuristic mode the model's cudnn_autotune is switched
    off).

Prints each reading with the card's nvidia-smi name and power limit and
writes them to OUT. Runs on the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONVS = {"encoder 64->64 3x3, 20 x 320 x 512": (20, 320, 512, 64, 64),
         "gru04 384->128 3x3, 10 x 80 x 128": (10, 80, 128, 384, 128)}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def top_kernels(prof, n: int = 6) -> list:
    import torch

    ks = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ks.sort(key=lambda e: -e.self_device_time_total)
    return [(round(e.self_device_time_total / 1e3, 3), e.count, e.key[:100]) for e in ks[:n]]


def time_ms(fn, reps: int = 5) -> float:
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


def conv_readings(card: str, mode: str) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from ppmstereo_tpu_torch.utils.device import cudnn_autotune

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (n, h, w, cin, cout) in CONVS.items():
        x = torch.randn(n, h, w, cin, generator=gen, device="cuda")
        wt = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / (cin * 9) ** 0.5
        layouts = {"channels-last view": lambda: x.movedim(-1, 1),
                   "contiguous NCHW": lambda: x.movedim(-1, 1).contiguous()}
        results = {}
        for layout, make in layouts.items():
            name = f"{layout}, {mode}"
            xin = make()
            stack = contextlib.ExitStack()
            stack.enter_context(cudnn_autotune(mode == "autotuned"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            y = F.conv2d(xin, wt, None, 1, 1)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            ms = time_ms(lambda: F.conv2d(xin, wt, None, 1, 1))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                F.conv2d(xin, wt, None, 1, 1)
                torch.cuda.synchronize()
            stack.close()
            first = results[next(iter(results))]["out"] if results else y
            results[name] = dict(ms=ms, peak_gb_above_input=peak, top=top_kernels(prof, 4),
                                 max_abs_diff=(y - first).abs().max().item(), out=y)
            print(f"conv {label}, {name}, f32 (no TF32) on {card}: {ms:.3f} ms, peak "
                  f"{peak:.2f} GB above the input, max |diff| from the first "
                  f"{results[name]['max_abs_diff']:.3e}; kernels {results[name]['top']}",
                  flush=True)
        for r in results.values():
            del r["out"]
        out[label] = results
        del x, wt, y, first
        torch.cuda.empty_cache()
    return out


def window_reading(card: str, mode: str) -> dict:
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.models import raft_stereo
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    if mode == "heuristic":
        raft_stereo.cudnn_autotune = contextlib.nullcontext
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.uniform(0, 255, (10, 2, 320, 512, 3)).astype(np.float32)).cuda()
    pred = model_zoo("RAFTStereoModel", kernel_size=10, iters=32, seed=5)
    run = pred.predictor._run_window
    seconds = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(clip[:, 0], clip[:, 1])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"RAFTStereoModel window of 10 frames at 320x512, f32, 32 iterations, {mode}, on "
          f"{card}: first call {seconds[0]:.3f} s, second {seconds[1]:.3f} s (peak "
          f"{peak:.2f} GB)", flush=True)
    return dict(first_s=seconds[0], second_s=seconds[1], peak_gb=peak)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "f32_convs.json"))
    p.add_argument("--mode", choices=("heuristic", "autotuned"), default=None,
                   help="one mode in this process (default: each in a child process)")
    args = p.parse_args()
    if args.mode is None:
        readings = {}
        for mode in ("heuristic", "autotuned"):
            part = Path(args.out).with_suffix(f".{mode}.json")
            subprocess.run([sys.executable, __file__, "--mode", mode, "--out", str(part)],
                           check=True)
            readings[mode] = json.loads(part.read_text())
        Path(args.out).write_text(json.dumps(readings, indent=1))
        print(readings["autotuned"]["card"])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    readings = dict(card=card, mode=args.mode, cudnn=torch.backends.cudnn.version(),
                    torch=torch.__version__, conv=conv_readings(card, args.mode),
                    window=window_reading(card, args.mode))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(readings, indent=1, default=str))


if __name__ == "__main__":
    main()
