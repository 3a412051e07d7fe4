#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PPMStereo on one NVIDIA card.

    python3 chip_smoke.py

Phases, each between timestamped progress lines (so a cut run shows where
it stopped):

  1. device    require a CUDA card; print its name, count, power limit
  2. build     compile every kernel of the main path with nvcc
  3. kernels   hold each kernel against its plain PyTorch version on the card
               at the main path's shapes; time kernel, plain version and the
               library call (SDPA) with CUDA events
  4. small parity  the whole CUDA path against the port's CPU path on a
               small clip in f32 (the CPU path is the one the tests hold
               against the JAX package)
  5. main      strict sliding-window PPMStereo at 320x512, window 10,
               10 iterations, through the port's `model_zoo` predictor with
               the committed anchor weights, on a 20-frame synthetic clip
               with known disparity; check shape, finiteness, accuracy and
               the kernel's launch count
  6. profile   one more 10-frame window under torch.profiler: device time
               by layer and the device's busy share

Every failure raises, so the exit code is not 0. The second-to-last lines
are the card's `nvidia-smi` name and power limit and a JSON line with one
record per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
ANCHOR = REPO / "checkpoints" / "anchor_r5.npz"
H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM

# main path
CLIP_FRAMES, HEIGHT, WIDTH = 20, 320, 512
WINDOW, ITERS = 10, 10
# play attention launches per window: 1/16 and 1/8 stages run iters // 2
# iterations, the 1/4 stage runs iters
LAUNCHES_PER_WINDOW = ITERS // 2 + ITERS // 2 + ITERS
# the anchor's strict EPE at this operating point, recorded by the JAX
# package (EPE_r05.json: 0.337 px over 10 synthetic sequences); one
# sequence through the port must stay well inside this bound
EPE_BOUND_PX = 1.0

_T0 = time.perf_counter()


def log(msg: str) -> None:
    stamp = time.strftime("%H:%M:%S")
    print(f"[{stamp} +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    log(f"phase {name}: start")
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: done in {time.perf_counter() - t0:.1f}s")


def nvidia_smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phases
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_name_and_limit()
    log(f"device {name!r}, count {count}, nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    from ppmstereo_tpu_torch.utils.device import set_precision

    set_precision()
    return name, count, smi


def phase_build():
    from ppmstereo_tpu_torch.kernels import _build

    built = _build.build("play_attention")
    log(f"play_attention built in {built.seconds:.1f}s -> {built.path.relative_to(REPO)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  nvcc: {line.strip()}")
    return built.seconds


# (label, rows B, Lq, Lk): the play shapes of a 320x512 window of 10 frames
# (Lq = (H/s)(W/s) tokens per frame, Lk = top_k * Lq), plus an unaligned case
PLAY_SHAPES = (
    ("1/4", 10, 80 * 128, 5 * 80 * 128),
    ("1/8", 10, 40 * 64, 5 * 40 * 64),
    ("1/16", 10, 20 * 32, 5 * 20 * 32),
    ("unaligned", 3, 1000, 4999),
)


def phase_kernels(smi: str):
    import torch
    import torch.nn.functional as F

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, lq, lk in PLAY_SHAPES:
        q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
        k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
        v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
        got = pa.play_attention(q, k, v, scale)
        ref = pa.play_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        # bf16 output: one ulp (2^-7 relative) at the largest |output|, plus
        # the bf16 rounding of the probabilities before P V (2^-8 relative,
        # at most 2^-8 max|v| in a weighted mean of v)
        tol = 2**-7 * ref.float().abs().max().item() + 2**-8 * v.float().abs().max().item()
        # on average: both sides round nearby f32 values to bf16 and differ
        # by an ulp only where a rounding boundary lies between them; the
        # f32 values differ by the probabilities' roundings, about 2^-9 of
        # |o| on average, so the mean difference stays near 2^-9 mean|o|.
        # An output one ulp off everywhere reads about 2^-7.5 mean|o|.
        mean_tol = 2**-8 * ref.float().abs().mean().item()
        finite = bool(torch.isfinite(got).all().item())
        log(f"play {label} B={b} Lq={lq} Lk={lk}: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"mean_abs_err {mean_err:.3e} (tol {mean_tol:.3e}), finite {finite}")
        if not finite or not err <= tol or not mean_err <= mean_tol:
            raise RuntimeError(f"play_attention kernel disagrees with its plain version at {label}")
        reps = 3 if lq * lk > 1e8 else 20
        ms = cuda_time_ms(lambda: pa.play_attention(q, k, v, scale), reps)
        plain_ms = cuda_time_ms(lambda: pa.play_attention_plain(q, k, v, scale), 1 if reps == 3 else 5)
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=scale
            ),
            reps,
        )
        flops, nbytes = pa.play_attention_cost(b, lq, lk)
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        log(
            f"play {label}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}) on {smi}"
        )
        rows.append(dict(
            shape=label, B=b, Lq=lq, Lk=lk, max_abs_err=err, tol=tol,
            mean_abs_err=mean_err, mean_tol=mean_tol, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        ))
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    return rows


def synthetic_clip(frames: int, h: int, w: int, seed: int):
    """A stereo clip with known disparity: three textured layers at fixed
    disparities (4 to 48 px), two of them discs in front, drifting over
    time; the JAX package's synthetic dataset, with a numpy blur.
    Returns (frames, 2, h, w, 3) float32 in [0, 255] and (frames, h, w)
    disparity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_layers = 3
    disps = np.sort(rng.uniform(4, 48, n_layers))[::-1]
    sigma = 3.0
    taps = np.arange(-9, 10)
    kern = np.exp(-0.5 * (taps / sigma) ** 2)
    kern /= kern.sum()

    def blur(tex):
        out = tex.astype(np.float32)
        for axis in (0, 1):
            pad = [(9, 9) if a == axis else (0, 0) for a in range(3)]
            xp = np.pad(out, pad, mode="reflect")
            n = out.shape[axis]
            out = sum(k * np.take(xp, np.arange(i, i + n), axis=axis)
                      for i, k in enumerate(kern))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)

    textures = [blur(rng.integers(0, 255, (h, w + 128, 3)).astype(np.uint8))
                for _ in range(n_layers)]
    yy, xx = np.mgrid[0:h, 0:w]
    masks = []
    for _ in range(n_layers - 1):
        cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        r = rng.uniform(0.15, 0.3) * min(h, w)
        masks.append(((xx - cx) ** 2 + (yy - cy) ** 2) < r * r)
    drift = rng.integers(1, 4, n_layers)
    video = np.empty((frames, 2, h, w, 3), np.float32)
    gt = np.empty((frames, h, w), np.float32)
    for ti in range(frames):
        for li in range(n_layers - 1, -1, -1):  # far to near
            tex = np.roll(textures[li], int(ti * drift[li]), axis=1)
            d = int(round(disps[li]))
            region = masks[li] if li < n_layers - 1 else np.ones((h, w), bool)
            video[ti, 0][region] = tex[:, 64: 64 + w][region]
            video[ti, 1][region] = tex[:, 64 + d: 64 + d + w][region]
            gt[ti][region] = disps[li]
    return video, gt


def phase_small_parity():
    """The whole CUDA path against the port's CPU path (plain play attention,
    which tests/test_torch_model.py holds against the JAX package) on a
    small clip, in f32 with the anchor weights. A CPU run with a wrong play
    step (its softmax scale doubled) shows how far the limit sits below a
    fault."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models import ppm_stereo
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    torch.set_num_threads(8)
    video, _ = synthetic_clip(5, 64, 128, seed=1)
    left = torch.from_numpy(video[None, :, 0])
    right = torch.from_numpy(video[None, :, 1])
    flat = load_npz(ANCHOR)
    outs = {}
    for run, dev in (("cpu", "cpu"), ("cuda", "cuda"), ("fault", "cpu")):
        model = ppm_stereo.PPMStereo(iters=4, mixed_precision=False)
        load_flax_params(model, flat)
        model.to(dev).eval()
        if run == "fault":
            ppm_stereo.play_attention = lambda q, k, v, scale: pa.play_attention(q, k, v, 2 * scale)
        try:
            disp, _ = model(left.to(dev), right.to(dev))
        finally:
            ppm_stereo.play_attention = pa.play_attention
        outs[run] = disp.cpu().numpy()
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    fault = float(np.abs(outs["fault"] - outs["cpu"]).max())
    # the kernel rounds unnormalised probabilities to bf16 where the plain
    # version rounds normalised ones: ~2^-8 relative in a few play outputs.
    # On an H100 this read 7.8e-5 px, and the wrong play step 1.37e-3 px:
    # the limit sits between the two.
    tol = 3e-4
    log(f"small clip (1, 5, 64, 128), f32: cuda vs cpu max |disparity diff| {err:.3e} px "
        f"(tol {tol}); a wrong play step reads {fault:.3e} px")
    if not np.isfinite(outs["cuda"]).all() or not err <= tol:
        raise RuntimeError("the CUDA path disagrees with the CPU path on the small clip")
    if not fault > tol:
        raise RuntimeError("the small-clip limit does not catch a wrong play step")
    return err, fault


def phase_main(smi: str):
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.utils.weights import load_npz

    video, gt = synthetic_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=0)
    pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS,
                     params=load_npz(ANCHOR))
    window_fn = pred.predictor.window_fn
    window_s = []

    def timed_window(left, right):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = window_fn(left, right)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
        log(f"  window {len(window_s)} of {left.shape[1]} frames: {window_s[-1]:.3f}s")
        return out

    pred.predictor.window_fn = timed_window
    torch.cuda.reset_peak_memory_stats()
    pa.play_attention.launches = 0
    out = pred({"stereo_video": video})
    launches = pa.play_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    disp = out["disparity"]
    expected_shape = (CLIP_FRAMES, HEIGHT, WIDTH, 1)
    if disp.shape != expected_shape or not np.isfinite(disp).all():
        raise RuntimeError(f"disparity has shape {disp.shape} (want {expected_shape}) "
                           f"or non-finite values")
    expected = LAUNCHES_PER_WINDOW * len(window_s)
    if launches != expected:
        raise RuntimeError(f"play_attention launched {launches} times, expected {expected}")
    epe = float(np.abs(disp[..., 0] - gt).mean())
    if not epe <= EPE_BOUND_PX:
        raise RuntimeError(f"EPE {epe:.3f} px exceeds {EPE_BOUND_PX} px")
    steady = window_s[1:] or window_s
    log(f"main path {CLIP_FRAMES}x{HEIGHT}x{WIDTH}, window {WINDOW}, iters {ITERS}: "
        f"{len(window_s)} windows, seconds per window {[round(s, 3) for s in window_s]} "
        f"(after the first: mean {sum(steady) / len(steady):.3f}s), "
        f"peak memory {peak_gb:.2f} GB, play launches {launches} "
        f"({LAUNCHES_PER_WINDOW} per window), EPE {epe:.3f} px on {smi}")
    pred.predictor.window_fn = window_fn
    return dict(launches=launches, window_s=window_s, peak_gb=peak_gb, epe=epe,
                pred=pred, video=video)


# kernel-name fragments -> the layer that launches them
_KERNEL_GROUPS = (
    ("play attention (CUDA kernel)", ("play_attention",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "splitk")),
    ("gathers and indexing", ("gather", "index", "scatter")),
    ("reductions and normalisation", ("reduce", "norm", "softmax", "welford")),
)


def phase_profile(main_run: dict, smi: str):
    """One steady 10-frame window under torch.profiler: device time by
    layer, the device's busy share, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    video = torch.from_numpy(main_run["video"][5:5 + WINDOW]).cuda()
    run = main_run["pred"].predictor._run_window
    run(video[:, 0], video[:, 1])  # this shape is warm already; once more
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(video[:, 0], video[:, 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        log("profile: the profiler saw no device time; breakdown not measured")
        return None
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["elementwise and other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        group = next((name for name, frags in _KERNEL_GROUPS
                      if any(f in key for f in frags)), "elementwise and other")
        groups[group] += e.self_device_time_total / 1e3
    log(f"profile of one {WINDOW}-frame window: wall {wall_ms:.1f} ms (profiler on), "
        f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches, on {smi}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {ms:.1f} ms ({100 * ms / device_ms:.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  top kernel {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, groups=groups)


def main() -> None:
    with phase("device"):
        kind, count, smi = phase_device()
    with phase("build"):
        build_s = phase_build()
    with phase("kernels"):
        rows = phase_kernels(smi)
    with phase("small parity"):
        phase_small_parity()
    with phase("main"):
        main_run = phase_main(smi)
    with phase("profile"):
        phase_profile(main_run, smi)

    worst = max(rows, key=lambda r: r["max_abs_err"] / r["tol"])
    quarter = rows[0]
    record = {
        "name": "play_attention_fwd",
        "route": "cuda",
        "source": "ppmstereo_tpu_torch/csrc/play_attention.cu",
        "replaces": "ppmstereo_tpu/kernels/play_attention.py:58",
        "launches": main_run["launches"],
        "max_abs_err": worst["max_abs_err"],
        "tol": worst["tol"],
        "mean_abs_err": worst["mean_abs_err"],
        "mean_tol": worst["mean_tol"],
        "ms": quarter["ms"],
        "plain_ms": quarter["plain_ms"],
        "bound_ms": quarter["bound_ms"],
        "bound_by": quarter["bound_by"],
        "library_ms": quarter["library_ms"],
        "build_s": build_s,
        "shapes": rows,
    }
    log(f"total {time.perf_counter() - _T0:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
