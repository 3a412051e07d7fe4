#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PPMStereo on one NVIDIA card.

    python3 chip_smoke.py

Phases, each between timestamped progress lines (so a cut run shows where
it stopped):

  1. device    require a CUDA card; print its name, count, power limit
  2. build     compile every kernel library with nvcc (forward and ring
               hop, backward, lookup), one nvcc each, in parallel; require
               wgmma (HGMMA) and TMA loads (UTMALDG) in the SASS of kernels
               1-5 and no ptxas spills in them; print kernel 6's registers
               and spills
  3. kernels   hold each play kernel (1-5) against its plain PyTorch version
               on the card at the main paths' shapes and three ragged ones,
               each check with a max-abs and a mean-abs limit and a fault
               reading that must fail them; kernels 3, 4 and 5 launched
               twice must give the same bits; kernel 5 (the ring hop) over
               K/V split into 1, 2 and 4 hops, hop by hop and normalised
               against kernel 1, and at the 2-way ring's hop shape from the
               empty state and from a second hop's; time kernel, plain
               version and the library call (SDPA's forward; its backward
               alone for kernels 3 and 4) with CUDA events
  3b. lookup   kernel 6 (the pyramid lookup) against its plain version at
               the three stages' pyramids and a ragged one, each in f32 and
               bf16 with f32 and bf16 output, bit-equal required (and
               within a few-ulp limit a fault fails); times beside four
               grid_samples, device times with the L2 warm and flushed;
               the instances of radius 2, 3 and 4 with 3 and 4 levels on the
               1/4 pyramid in bf16 and f32, bit-equal, with their device
               times (the shipped instance beside the radius-4-only kernel's)
  4. small parity  the whole CUDA inference path against the port's CPU path
               on a small clip in f32 (the CPU path is the one the tests
               hold against the JAX package)
  5. train small parity  one train step in f32 on a small clip on the card
               against the port's CPU path (loss, every gradient, the
               updated parameters); a card run with a wrong backward (dk
               doubled in the kernels' output) must fail the same limits
  6. main      inference: strict sliding-window PPMStereo at 320x512,
               window 10, 10 iterations, through the port's `model_zoo`
               predictor with the committed anchor weights, on a 20-frame
               synthetic clip with known disparity; check shape, finiteness,
               accuracy and the launch counts of kernels 1 and 6; one
               steady window again with the plain lookup patched in, whose
               disparity must equal the kernel's bit for bit
  7. profile   one more 10-frame window under torch.profiler: device time
               by layer, kernel 6's launches and the device's busy share
  7'. aux      the modules no model calls, at the shipped model's widths at
               320x512 (FlowHead3DFFT, SKMotionEncoder, ResNetFPN,
               MultiLevelResNetFPN, LocalFeatureTransformer with full
               attention, Mlp, RelPosEmb), each with seeded weights carried
               through utils/weights.py: f32 on the card against the CPU
               (TF32 off; the LoFTR layers' linear attention on the same
               weights must fail the limit), bf16 timed; one steady window
               of the main path timed with utils/profiling.py's `timed` and
               traced with its `trace` (20 launches each of kernels 1 and 6
               required in the written Chrome trace); the roofline of its
               analytic counts beside kernel 1's time and the window's device
               time; a 720x1280 PFM and FLO read by the native readers
               (data/native.py, built with g++) and by numpy: equal, host ms
  7a. modes    the main path's clip through `model_zoo` in each window mode
               (strict, batch_windows=2, encoder_cache, fast_mode,
               warm_start with warm_iters 10, warm_start with the encoder
               cache), each run twice and the second timed: seconds per
               window, frames per second, kernel 1's and 6's launches,
               EPE/TEPE, peak memory; the strict modes held against the
               strict run, the others to the EPE bound, and every warm
               window after the first launching kernel 1 warm_iters times;
               whether each strict mode is bit-equal to strict is printed,
               and encoder_cache must be (tools/window_bits.py locates
               where batch_windows=2 parts from strict)
  7a'. config  two non-default PPMStereoConfig's at full width (A: no
               context net, no attention, top_k = the window; B: the 2-D
               convex upsample, a 3-level radius-3 lookup, two SST rounds),
               untrained, one strict 320x512 window each: seconds, kernels
               1 and 6 launched 20 times each, the disparity against the
               same window with every kernel swapped for its plain function
               (a wrong lookup must fail the limit); a play head dim other
               than 128 raises and launches nothing
  7a''. zoo    the zoo's baselines at their shipped configurations (full
               width), untrained (the port's seeded initialisation):
               DynamicStereoModel (bf16, 20 iterations), RAFTStereoModel
               (f32, 32) and BiDAStereoModel (f32, 10, with its frozen
               RAFT). Each: the card's f32 path against the CPU path on a
               small clip (a lookup read one pixel to the right must fail
               the limits); one strict window of 10 frames at 320x512
               (BiDAStereo 256x384, to keep the phase near 90 s) through
               `model_zoo`: seconds (the second call), peak memory, kernel
               6's launches (40, 32 and 0, required), the device time by
               layer of a profiled call (BiDAStereo's RAFT, its 2-D pyramid
               and lookup, TFCL and the flow warps named); for DynamicStereo
               and RAFT-Stereo the window again with the plain lookup in
               kernel 6's place, bit-equal required. Then DynamicStereoModel
               through `run_eval` with the port's `real` preset (40 frames
               at 720x1280, window 20, 20 iterations, bf16) on a Dynamic
               Replica-layout real/<sequence> tree written from a synthetic
               clip: fps, seconds and kernel 6 launches per window (40),
               peak memory
  7a'''. vda   the Video-Depth-Anything family at its shipped
               configurations (ViT-S, untrained): PPMStereoVDAModel (bf16,
               20 iterations) and StereoAnyVideoModel (f32, 12), one strict
               window of 10 frames at 320x512 each through `model_zoo`: the
               first call's seconds, the median of three steady calls, peak
               memory, kernels 1 and 6 launched 40 times each in every
               PPMStereo-VDA window and never in StereoAnyVideo's, a profiled
               call (device busy share, the backbone's and AAPC's shares
               of device time). PPMStereo-VDA: every kernel call against its plain
               function (kernel 1 within phase kernels' limits, kernel 6 bit
               for bit), the window against the plain functions' (a wrong
               lookup must fail the limit) and bit-equal to its plain-lookup
               twin. StereoAnyVideo: the card's f32 path against the CPU path
               on the small clip
  7b. eval     the Dynamic Replica 40-frame protocol at 720x1280 (window 20,
               20 iterations, bf16, the anchor) through the evaluate CLI's
               `run_eval` and the port's preset, on a Dynamic Replica tree
               written from a synthetic clip (PNG frames, float16 depth):
               the aggregate metrics and fps, seconds and kernel launches
               per window, peak memory and the reader's host seconds; the
               reader's disparity against the clip's, run_eval's disparity
               against a direct call of its predictor (bit for bit), EPE
               under its bound; one steady 20-frame window profiled; kernel
               1 at the 720p 1/4 shape (B.T 40, first and last rows) and
               kernel 6 at the 720p pyramid against their plain versions
  7c. ring     the main path again in 2 processes on the one card, its play
               steps as the ring play attention (kernel 5) over a gloo group
               staged through the host; kernel 5's and kernel 6's
               launches, the disparity and EPE against the main run; one
               steady window under torch.profiler for kernel 5's device
               time per window and rank; each
               ringed play step of the clip's first window against the
               unsharded play on the same inputs; and the small clip in f32 through the ring against
               the card's single-process output; a dropped carry as the
               fault of both
  7d. data     the mesh's data axis in 2 processes on the one card (gloo,
               host-staged), each piece against the same work in this
               process: 3 train steps at TrainConfig() on one batch of 2
               (one clip a rank; losses, per-step seconds, the gradient
               all-reduce's bytes and seconds, kernels 2-4 per rank and
               step, the ranks' parameters bit-equal after every step), an
               f32 step of the train small parity's clip at batch 2 at the
               train limits, the main path's clip through
               model_zoo(batch_windows=2, mesh) (kernels 1 and 6 per rank,
               the strict modes' limits), and evaluate_distributed on three
               sequences of unequal length
  7e. seq      the mesh's seq axis in 2 processes on the one card (gloo,
               host-staged): the main path's clip through model_zoo(mesh=
               seq 2), each window of 10 frames spread 5 + 5, the tail of 5
               whole on both; kernels 1 and 6 launched 20 times a window
               and rank, seconds per window, bytes received per window
               (bank, halos, other frames), the disparity and EPE against
               the main run at the strict modes' limits; the small clip (4
               frames) in f32 under seq 2 against the card's single-process
               f32 output at the ring's limit, which zeroed halos and an
               ungathered bank must exceed, and under seq x space 2 x 2 (4
               processes, kernel 5) each ringed play step against the
               unsharded play on its inputs at kernel 1's limits
  7f. seq_train  the mesh's seq axis in training, 2 processes on the one
               card (gloo, host-staged): 3 train steps at TrainConfig() with
               6-frame clips (3 a rank; the shipped 5 does not divide over
               2) from the anchor on one batch, through `train()`, against
               the same steps in this process (bf16 losses within 1e-2),
               the ranks' parameters bit-equal after every step, kernels
               2-4 launched 40 / 20 / 20 times a step and rank (the
               wrappers' counts, and in the third step's profiler trace),
               seconds per step, peak memory, bytes received per step in
               the forward and the backward (the recomputed iterations'
               messages and the cotangents sent back); an f32 step of a
               4-frame clip at 64x128 over seq 2 against one process at
               tests/torch_train_parity.py's limits
  8. train     training: `train()` at the shipped TrainConfig() (320x512,
               5 frames, batch 2, 10 iterations, bf16) from the anchor, 4
               steps on one batch of the synthetic fallback, then 2 on fresh
               batches; check finite losses, a falling loss on the fixed
               batch, moving parameters and a frozen ConvNeXt, and each
               training kernel's launches per step; one more step profiled;
               then the reference recipe: the train CLI with --config (a
               YAML preset of TrainConfig()) on the SceneFlow + Dynamic
               Replica mixture of two trees written from synthetic clips
               (batches from both), and train(enable_eval=True,
               save_callback=...) for 2 steps: the callback at the save,
               the in-training evaluation on kernels 1 and 6
  8b. train_zoo  training the rest of the zoo: PPMStereo-VDA, DynamicStereo,
               BiDAStereo and StereoAnyVideo, each at TrainConfig(
               model_name=...) from the port's seeded initialisation: one
               f32 step on a small clip on the card against the port's CPU
               path (phase train small parity's limits) and the card's bf16
               step's loss against it; 4 steps on one batch of the
               synthetic fallback and 1 on a fresh one: finite losses, a
               falling loss on the fixed batch, every trainable tensor with
               a significant gradient moved, every frozen tensor (the
               ConvNeXt, the VDA backbones, BiDAStereo's RAFT) bit-equal,
               kernels 2 / 3 / 4 launched 40 / 20 / 20 times a step by
               PPMStereo-VDA and no kernel by the other three; seconds per
               step, peak memory, the busy share of one profiled step; then
               one step of PPMStereo-VDA's train(enable_eval=True), its
               evaluation on kernels 1 and 6

Every failure raises, so the exit code is not 0. The second-to-last lines
are the card's `nvidia-smi` name and power limit and a JSON line with one
record per kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
ANCHOR = REPO / "checkpoints" / "anchor_r5.npz"
H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM

# inference path
CLIP_FRAMES, HEIGHT, WIDTH = 20, 320, 512
WINDOW, ITERS = 10, 10
# play attention launches per window: 1/16 and 1/8 stages run iters // 2
# iterations, the 1/4 stage runs iters
LAUNCHES_PER_WINDOW = ITERS // 2 + ITERS // 2 + ITERS
# the anchor's strict EPE at this operating point, recorded by the JAX
# package (EPE_r05.json: 0.337 px over 10 synthetic sequences); one
# sequence through the port must stay well inside this bound
EPE_BOUND_PX = 1.0

# training path: TrainConfig() defaults (320x512, 5 frames, batch 2, 10
# iterations); kernel launches per train step (20 play calls a forward; the
# forward kernel with its residual runs again when the checkpointed
# iterations are recomputed in the backward pass)
TRAIN_FIXED_STEPS, TRAIN_FRESH_STEPS = 4, 2
TRAIN_LAUNCHES_PER_STEP = {"play_attention_fwd_res": 2 * LAUNCHES_PER_WINDOW,
                           "play_attention_bwd_dq": LAUNCHES_PER_WINDOW,
                           "play_attention_bwd_dkv": LAUNCHES_PER_WINDOW,
                           "play_attention_fwd": 0, "corr_lookup": 0}

# train small parity limits: loss relative, gradient (see grad_agreement)
# and the share of parameter elements whose first update differs by more
# than lr / 2. On an H100 the card read 8.8e-7 (loss); gradients 6.5e-4 at
# worst over the tensors of more than one element (the 1/4 stage's `to_v`)
# against 8.35e-3 with the wrong backward (dk doubled in the card's
# kernels: `cnet.decode_4x`, which makes the 1/4 stage's keys), so the
# limit 2.5e-3 sits 3.8x above the one and 3.3x below the other; the three
# one-element play blends `beta` read up to 3.87e-3 (each gradient is one
# sum over the whole field with much cancellation, and it sees the kernels'
# bf16 roundings), limit 5.6e-3; and 2.9e-7 (update). A wrong dk (or dq)
# cannot move the blends: on the CPU it changes none of their gradients at
# f32 resolution (q and k come from the context features, not from the
# iterations' state the blends feed). A wrong dv does: doubled, it moves
# them by 7.0e-3, 7.1e-2 and 1.0e-2 on the CPU, so the blends' limit is held
# against the card's kernels with dv doubled. tests/test_torch_train.py reads 6.7e-4 between the port's CPU
# path and JAX by the same per-tensor norm ratio.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 2.5e-3
TRAIN_SCALAR_GRAD_TOL = 5.6e-3
TRAIN_UPDATE_TOL = 1e-2

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


KERNEL_LIBRARIES = ("play_attention_fwd", "play_attention_bwd", "corr_lookup")
# the instructions the Hopper kernels must be made of: wgmma (HGMMA in SASS)
# and TMA tile loads (UTMALDG)
SASS_REQUIRED = ("HGMMA", "UTMALDG")
# {library: {kernel record: a fragment of its mangled name}}: the kernels
# that must hold SASS_REQUIRED (the forward template's mode is mangled as
# ILi0E for kernel 1, ILi1E for kernel 2 and ILi2E for kernel 5). Kernel 6,
# a gather, needs neither; its registers and spills are printed.
HOPPER_KERNELS = {
    "play_attention_fwd": {"play_attention_fwd": "play_attention_fwd_kernelILi0E",
                           "play_attention_fwd_res": "play_attention_fwd_kernelILi1E",
                           "play_attention_carry": "play_attention_fwd_kernelILi2E"},
    "play_attention_bwd": {"play_attention_bwd_dq": "play_attention_bwd_dq_kernel",
                           "play_attention_bwd_dkv": "play_attention_bwd_dkv_kernel"},
}


def phase_build():
    """Build every kernel library at once (one nvcc each, in parallel); check
    that the Hopper kernels' machine code holds wgmma and TMA loads and that
    ptxas spilled nothing in them; read kernel 6's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from ppmstereo_tpu_torch.kernels import _build

    with ThreadPoolExecutor(len(KERNEL_LIBRARIES)) as pool:
        built = dict(zip(KERNEL_LIBRARIES, pool.map(_build.build, KERNEL_LIBRARIES)))
    for name, lib in built.items():
        log(f"{name} built in {lib.seconds:.1f}s -> {lib.path.relative_to(REPO)}")
        for line in lib.log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "warning", "setmaxnreg",
                                       "Function properties")):
                log(f"  nvcc: {line.strip()}")
    sass = {}
    for library, kernels in HOPPER_KERNELS.items():
        found = library_sass_counts(built[library].path, kernels)
        spills = ptxas_spills(built[library].log, kernels)
        for record, counts in found.items():
            sass[record] = dict(counts, spill_bytes=spills[record])
        log(f"{library} SASS and ptxas spill bytes: {[sass[r] for r in kernels]}")
    sass["corr_lookup"] = ptxas_resources(built["corr_lookup"].log, "corr_lookup_kernel")
    log(f"corr_lookup (kernel 6) ptxas, per instance (pyramid, output dtype): "
        f"{sass['corr_lookup']}")
    return {name: lib.seconds for name, lib in built.items()}, sass


def ptxas_resources(log_text: str, fragment: str) -> dict:
    """{function: {"registers": n, "spill_bytes": n}} from nvcc's
    `-Xptxas -v` output for every function whose mangled name holds
    `fragment` (no check: a reading)."""
    found, name = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            if fragment not in name:
                name = None
        elif name is not None and "spill stores" in line:
            got = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            found.setdefault(name, {})["spill_bytes"] = int(got.group(1)) + int(got.group(2))
        elif name is not None and "Used" in line and "registers" in line:
            found.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return found


def library_sass_counts(lib_path, kernels: dict) -> dict:
    """`sass_counts` of the library's `cuobjdump --dump-sass`."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return sass_counts(dump, kernels)


def sass_counts(dump: str, kernels: dict) -> dict:
    """Count the SASS_REQUIRED instructions in each function of a
    `cuobjdump --dump-sass` text; return {record: counts} for `kernels`
    ({record: a fragment of the function's mangled name}). Raise unless each
    record matches exactly one function and that function holds every one of
    the instructions."""
    counts, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_REQUIRED, 0)
        elif name is not None:
            for op in SASS_REQUIRED:
                counts[name][op] += f" {op}" in line
    found = {}
    for record, fragment in kernels.items():
        matches = [n for n in counts if fragment in n]
        if len(matches) != 1:
            raise RuntimeError(f"{record}: {len(matches)} functions named like {fragment!r} "
                               f"in the SASS: {list(counts)}")
        found[record] = counts[matches[0]]
        if not all(found[record].values()):
            raise RuntimeError(f"{record}'s SASS lacks one of {SASS_REQUIRED}: {found[record]}")
    return found


def ptxas_spills(log_text: str, kernels: dict) -> dict:
    """{record: spill store bytes + spill load bytes} from nvcc's
    `-Xptxas -v` output (the "Function properties for <name>" line and the
    line after it) for `kernels` as in `sass_counts`. Raise when a record
    has no such lines or spills."""
    lines = log_text.splitlines()
    spills = {}
    for record, fragment in kernels.items():
        at = [i for i, line in enumerate(lines)
              if "Function properties for" in line and fragment in line]
        found = [re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
                 for i in at if i + 1 < len(lines)]
        if len(found) != 1 or found[0] is None:
            raise RuntimeError(f"{record}: no ptxas spill line for {fragment!r}")
        spills[record] = int(found[0].group(1)) + int(found[0].group(2))
        if spills[record]:
            raise RuntimeError(f"{record}: ptxas spilled {spills[record]} bytes")
    return spills


# (label, rows B, Lq, Lk): the play shapes of a 320x512 window of 10 frames
# (Lq = (H/s)(W/s) tokens per frame, Lk = top_k * Lq), which are also those
# of a training batch of 2 clips of 5 frames; plus three ragged cases, the
# last with a second row b whose lse and Di start off a 16-byte boundary
PLAY_SHAPES = (
    ("1/4", 10, 80 * 128, 5 * 80 * 128),
    ("1/8", 10, 40 * 64, 5 * 40 * 64),
    ("1/16", 10, 20 * 32, 5 * 20 * 32),
    ("unaligned", 3, 1000, 4999),
    ("tiny", 1, 17, 5),
    ("odd", 2, 65, 129),
)


def _agreement(label: str, name: str, got, want, fault, max_tol: float, mean_tol: float):
    """Max and mean |got - want| within their limits, and the same reading
    against a fault (`fault`, a wrong version of `want`) above both. A
    reading that no fault of interest can move (the first hop of a ring,
    from the empty state, where alpha multiplies zeros) passes fault=None."""
    import torch

    diff = (got.float() - want.float()).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    finite = bool(torch.isfinite(got).all().item())
    line = (f"  {name} {label}: max_abs_err {err:.3e} (tol {max_tol:.3e}), mean_abs_err "
            f"{mean_err:.3e} (tol {mean_tol:.3e})")
    out = dict(max_abs_err=err, tol=max_tol, mean_abs_err=mean_err, mean_tol=mean_tol)
    if fault is not None:
        fdiff = (got.float() - fault.float()).abs()
        out.update(fault_max_abs_err=fdiff.max().item(), fault_mean_abs_err=fdiff.mean().item())
        line += f"; fault reads {out['fault_max_abs_err']:.3e} / {out['fault_mean_abs_err']:.3e}"
    log(line)
    if not finite or not err <= max_tol or not mean_err <= mean_tol:
        raise RuntimeError(f"{name} kernel disagrees with its plain version at {label}")
    if fault is not None and not (out["fault_max_abs_err"] > max_tol
                                  and out["fault_mean_abs_err"] > mean_tol):
        raise RuntimeError(f"{name} limits at {label} do not catch the fault reading")
    return out


def _bwd_plain_fault(q, k, v, do, scale):
    """A wrong backward for the fault readings: Di left out of dS (dq, dk)
    and dv taken with the softmax scale doubled."""
    import torch

    b, lq, _ = q.shape
    dq, dk, dv = (torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in (q, k, v))
    for bi in range(b):
        kf, vf, qf, gf = k[bi].float(), v[bi].float(), q[bi].float(), do[bi].float()
        for s0 in range(0, lq, 1024):
            s1 = min(s0 + 1024, lq)
            logits = qf[s0:s1] @ kf.t()
            p = logits.mul(scale).softmax(-1)
            ds = p * (gf[s0:s1] @ vf.t())  # no "- Di"
            dq[bi, s0:s1] = scale * ds @ kf
            dk[bi] += scale * ds.t() @ qf[s0:s1]
            dv[bi] += logits.mul(2 * scale).softmax(-1).t() @ gf[s0:s1]
    return dq, dk, dv


def phase_kernels(smi: str):
    """Kernels 1-4 against their plain versions at every shape, with
    limits and fault readings; times at every shape."""
    import torch
    import torch.nn.functional as F

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in ("fwd", "fwd_res", "bwd_dq", "bwd_dkv", "carry")}
    for label, b, lq, lk in PLAY_SHAPES:
        q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
        k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
        v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, lq, 128, generator=gen, device="cuda").bfloat16()
        shape = dict(shape=label, B=b, Lq=lq, Lk=lk)

        # kernel 1 (inference forward) and kernel 2 (forward with residual)
        got = pa.play_attention(q, k, v, scale)
        got_res, lse = pa.play_attention_fwd_res(q, k, v, scale)
        ref, ref_lse = pa.play_attention_fwd_res_plain(q, k, v, scale)
        fault = pa.play_attention_plain(q, k, v, 2 * scale)
        torch.cuda.synchronize()
        # bf16 output: one ulp (2^-7 relative) at the largest |output|, plus
        # the bf16 rounding of the probabilities before P V (2^-8 relative,
        # at most 2^-8 max|v| in a weighted mean of v). On average: both
        # sides round nearby f32 values to bf16 and differ by an ulp only
        # where a rounding boundary lies between them; the f32 values differ
        # by the probabilities' roundings, about 2^-9 of |o| on average, so
        # the mean difference stays near 2^-9 mean|o| (limit 2^-8 mean|o|;
        # an output one ulp off everywhere reads about 2^-7.5 mean|o|).
        o_tol = 2**-7 * ref.float().abs().max().item() + 2**-8 * v.float().abs().max().item()
        o_mean_tol = 2**-8 * ref.float().abs().mean().item()
        rows["fwd"].append(dict(shape, checks={"o": _agreement(
            label, "play_attention_fwd", got, ref, fault, o_tol, o_mean_tol)}))
        if not torch.equal(got, got_res):
            raise RuntimeError(f"kernel 2's o differs from kernel 1's at {label}")
        # lse: f32 sums of bf16 products in another order than the plain
        # version's; an lse off by 2^-12 changes every probability by
        # 2^-12.5 relative, a twentieth of a bf16 ulp: max 2^-12, mean 2^-16
        # (measured on the card: a few 1e-6). The fault: lse in nats.
        rows["fwd_res"].append(dict(shape, o_bit_equal_kernel_1=True, checks={
            "o": rows["fwd"][-1]["checks"]["o"],
            "lse": _agreement(label, "play_attention_fwd_res lse", lse, ref_lse,
                              ref_lse * math.log(2.0), 2**-12, 2**-16)}))

        # kernels 3 and 4
        dq, dk, dv = pa.play_attention_bwd(q, k, v, got_res, lse, do, scale)
        rq, rk, rv = pa.play_attention_bwd_plain(q, k, v, do, scale)
        fq, fk, fv = _bwd_plain_fault(q, k, v, do, scale)
        torch.cuda.synchronize()
        # bf16 outputs from f32 sums of bf16-rounded P and dS (2^-8 relative
        # each) where the plain version keeps f32: 1.5 ulps at the largest
        # |output| (3 * 2^-8 max|ref|), and on average 2^-7.5 mean|ref|: the
        # output's own rounding takes about 2^-9 mean|ref|, and with few
        # terms per output (17 queries, 5 keys) the roundings of P and dS
        # take nearly as much again (0.86 of 2^-8 measured at 1 x 17 x 5)
        checks = {}
        for name, g, r, f in (("dq", dq, rq, fq), ("dk", dk, rk, fk), ("dv", dv, rv, fv)):
            checks[name] = _agreement(label, f"play_attention_bwd {name}", g, r, f,
                                      3 * 2**-8 * r.float().abs().max().item(),
                                      2**-7.5 * r.float().abs().mean().item())
        # no atomics: a second launch gives the same bits
        again = pa.play_attention_bwd(q, k, v, got_res, lse, do, scale)
        equal = {name: bool(torch.equal(g, h)) for name, g, h in zip(("dq", "dk", "dv"),
                                                                     (dq, dk, dv), again)}
        log(f"  play_attention_bwd {label}: a second launch bit-equal {equal}")
        if not all(equal.values()):
            raise RuntimeError(f"kernels 3 and 4 are not deterministic at {label}: {equal}")
        del again
        rows["bwd_dq"].append(dict(shape, bit_equal_rerun=equal["dq"], checks={"dq": checks["dq"]}))
        rows["bwd_dkv"].append(dict(shape, bit_equal_rerun=equal["dk"] and equal["dv"],
                                    checks={"dk": checks["dk"], "dv": checks["dv"]}))

        rows["carry"].append(dict(shape, checks=_carry_checks(label, q, k, v, got, scale)))

        # times (CUDA events): kernel, plain version, library call
        big = lq * lk > 1e8
        reps, plain_reps = (3, 1) if big else (20, 5)
        di = pa.play_attention_di(got_res, do)
        qg, kg, vg = (x[:, None].detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            out.backward(do[:, None])

        # SDPA's backward alone, the same function as kernels 3 and 4
        # together: one forward, then its backward over the reps (the
        # gradients dropped before each, so none is accumulated)
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

        def sdpa_bwd():
            qg.grad = kg.grad = vg.grad = None
            sdpa_out.backward(do[:, None], retain_graph=True)

        times = dict(
            fwd=cuda_time_ms(lambda: pa.play_attention(q, k, v, scale), reps),
            fwd_plain=cuda_time_ms(lambda: pa.play_attention_plain(q, k, v, scale), plain_reps),
            fwd_res=cuda_time_ms(lambda: pa.play_attention_fwd_res(q, k, v, scale), reps),
            fwd_res_plain=cuda_time_ms(lambda: pa.play_attention_fwd_res_plain(q, k, v, scale),
                                       plain_reps),
            bwd_dq=cuda_time_ms(lambda: pa.play_attention_bwd_dq(q, k, v, do, lse, di, scale), reps),
            bwd_dkv=cuda_time_ms(lambda: pa.play_attention_bwd_dkv(q, k, v, do, lse, di, scale),
                                 reps),
            bwd_plain=cuda_time_ms(lambda: pa.play_attention_bwd_plain(q, k, v, do, scale),
                                   plain_reps),
            sdpa=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=scale), reps),
            sdpa_fwd_bwd=cuda_time_ms(sdpa_fwd_bwd, reps),
            sdpa_bwd=cuda_time_ms(sdpa_bwd, reps),
            di=cuda_time_ms(lambda: pa.play_attention_di(got_res, do), reps),
        )
        f_flops, f_bytes = pa.play_attention_cost(b, lq, lk)
        f_bound, f_by = _bound(f_flops, f_bytes)
        # the forward's lse output: 4 more bytes per row
        r_bound, r_by = _bound(f_flops, f_bytes + 4.0 * b * lq)
        dq_flops, dq_bytes = pa.play_attention_bwd_dq_cost(b, lq, lk)
        dkv_flops, dkv_bytes = pa.play_attention_bwd_dkv_cost(b, lq, lk)
        dq_bound, dq_by = _bound(dq_flops, dq_bytes)
        dkv_bound, dkv_by = _bound(dkv_flops, dkv_bytes)
        for name, ms, plain_ms, lib_ms, bound, by in (
                ("fwd", times["fwd"], times["fwd_plain"], times["sdpa"], f_bound, f_by),
                ("fwd_res", times["fwd_res"], times["fwd_res_plain"], times["sdpa"], r_bound, r_by),
                ("bwd_dq", times["bwd_dq"], times["bwd_plain"], times["sdpa_bwd"], dq_bound, dq_by),
                ("bwd_dkv", times["bwd_dkv"], times["bwd_plain"], times["sdpa_bwd"], dkv_bound,
                 dkv_by)):
            rows[name][-1].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                  bound_by=by)
        for name, flops in (("bwd_dq", dq_flops), ("bwd_dkv", dkv_flops)):
            rows[name][-1].update(tflops=flops / rows[name][-1]["ms"] / 1e9,
                                  sdpa_fwd_bwd_ms=times["sdpa_fwd_bwd"], di_ms=times["di"])
        carry_times = _carry_times(label, q, k, v, scale, smi)
        rows["carry"][-1]["checks"].update(carry_times.pop("hop_checks"))
        rows["carry"][-1].update(carry_times)
        log(f"play {label} B={b} Lq={lq} Lk={lk} on {smi}: " + ", ".join(
            f"{key} {val:.3f} ms" for key, val in times.items())
            + f"; bounds fwd {f_bound:.3f} ({f_by}), dq {dq_bound:.3f}, dk/dv {dkv_bound:.3f} ms; "
            f"fwd {f_flops / times['fwd'] / 1e9:.1f} TFLOP/s, bwd (dq + dk/dv, 10 B Lq Lk D) "
            f"{2.5 * f_flops / (times['bwd_dq'] + times['bwd_dkv']) / 1e9:.1f} TFLOP/s")
        del q, k, v, do, got, got_res, lse, ref, ref_lse, fault, dq, dk, dv, rq, rk, rv, fq, fk, fv
        del qg, kg, vg, di, sdpa_out
        torch.cuda.empty_cache()
    return rows


RING_WAYS = (1, 2, 4)  # kernel 5 checked over K/V split into these many hops


def _carry_fault(q, k, v, o, m, l, scale):
    """A wrong hop for the fault readings: alpha left out of the merge of o
    and l (o' = o + P V, l' = l + rowsum P; m' is the sound one)."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    o2, m2, l2 = pa.play_attention_carry_plain(q, k, v, o, m, l, scale)
    alpha = torch.exp2(m - m2)  # the sound merge took o2 = alpha o + P V
    return o2 + (1 - alpha)[..., None] * o, m2, l2 + (1 - alpha) * l


def _empty_state(b: int, lq: int):
    """The ring's starting state (0, -1e30, 0) for B x Lq query rows."""
    import torch

    return (torch.zeros(b, lq, 128, device="cuda"), torch.full((b, lq), -1e30, device="cuda"),
            torch.zeros(b, lq, device="cuda"))


def _hop_check(at: str, q, k, v, state, scale, empty: bool):
    """One hop of kernel 5 from `state` (o, m, l) against the plain hop on
    the same state, each of o, m, l with a max and a mean limit; from a
    state that is not empty the fault (alpha left out of the merge; m,
    which alpha does not touch, read in nats) must fail them. Returns the
    checks and the kernel's new state."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    ro, rm, rl = pa.play_attention_carry_plain(q, k, v, *state, scale)
    wrong = None
    if not empty:
        wo, _, wl = _carry_fault(q, k, v, *state, scale)
        wrong = (wo, rm * math.log(2.0), wl)
    state = pa.play_attention_carry(q, k, v, *state, scale)  # updates the state in place
    torch.cuda.synchronize()
    # o (f32, unnormalised: l times a weighted mean of v): the bf16 rounding
    # of P flips where the kernel's logits differ from the plain version's
    # in the last bits (2^-8 of p v at most per term), so as kernel 1's
    # limit with |o| in units of l: 2^-7 max|o| + 2^-8 max(l) max|v|, and on
    # average 2^-8 mean|o|. l: f32 sums of f32 probabilities (ex2.approx:
    # 2^-22 relative) in another order: 2^-16 of max l, 2^-18 of mean l on
    # average. m: as kernel 2's lse, 2^-12 and 2^-16.
    tols = dict(
        o=(2**-7 * ro.abs().max().item() + 2**-8 * rl.max().item() * v.float().abs().max().item(),
           2**-8 * ro.abs().mean().item()),
        m=(2**-12, 2**-16),
        l=(2**-16 * rl.max().item(), 2**-18 * rl.mean().item()))
    checks = {name: _agreement(at, f"play_attention_carry {name}", got, want,
                               None if wrong is None else wrong[i], *tols[name])
              for i, (name, got, want) in enumerate((("o", state[0], ro), ("m", state[1], rm),
                                                      ("l", state[2], rl)))}
    return checks, state


def _carry_checks(label: str, q, k, v, whole, scale) -> dict:
    """Kernel 5 at one shape: K/V split into n = 1, 2, 4 chunks, n hops from
    the empty state. Each hop's (o, m, l) against the plain hop on the same
    incoming state; the normalised result against kernel 1 on the whole K/V
    (`whole`) at kernel 1's o limits (the two are separate kernels that sum
    in other orders, so not bit for bit). The fault (alpha left out of the
    merge) must fail every hop after the first and every normalised result
    of n > 1 (m, which alpha does not touch, is read against m in nats); at
    n = 1 no such fault applies (one hop from the empty state, where alpha
    multiplies zeros)."""
    from ppmstereo_tpu_torch.kernels import play_attention as pa

    b, lq, _ = q.shape
    checks = {}
    for n in RING_WAYS:
        o, m, l = _empty_state(b, lq)
        fo, fm, fl = o.clone(), m.clone(), l.clone()
        for j, (kj, vj) in enumerate(zip(k.tensor_split(n, dim=1), v.tensor_split(n, dim=1))):
            kj, vj = kj.contiguous(), vj.contiguous()
            fo, fm, fl = _carry_fault(q, kj, vj, fo, fm, fl, scale)
            hop, (o, m, l) = _hop_check(f"{label} hop {j + 1} of {n}", q, kj, vj, (o, m, l),
                                        scale, empty=j == 0)
            checks.update({f"{name} n={n} hop {j + 1}": c for name, c in hop.items()})
        out = (o * (1.0 / l)[..., None]).bfloat16()
        v_max = v.float().abs().max().item()
        o_tol = 2**-7 * whole.float().abs().max().item() + 2**-8 * v_max
        o_mean_tol = 2**-8 * whole.float().abs().mean().item()
        at = f"{label} {n} hops, normalised, against kernel 1"
        checks[f"o n={n} normalised"] = _agreement(
            at, "play_attention_carry", out, whole,
            None if n == 1 else (fo / fl[..., None]).bfloat16(), o_tol, o_mean_tol)
        del o, m, l, fo, fm, fl
    return checks


def _carry_times(label: str, q, k, v, scale, smi: str) -> dict:
    """Kernel 5 at the hop shape of the 2-way ring (each rank's half of the
    query rows over its half of the bank): held against the plain hop from
    the empty state and from the state a hop over the other half of the
    bank left (the ring's second hop, where the fault applies); two
    launches from that state must give the same bits; then kernel, plain
    hop, SDPA's forward on the same q/k/v (the nearest library call, not
    the same function: it normalises and keeps no state), and the bound."""
    import torch
    import torch.nn.functional as F

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    b, lq, _ = q.shape
    hq, hk = max(lq // 2, 1), max(k.shape[1] // 2, 1)
    qh, kh, vh = q[:, :hq].contiguous(), k[:, :hk].contiguous(), v[:, :hk].contiguous()
    at = f"{label}, 2-way ring hop B={b} Lq={hq} Lk={hk}"
    checks, _ = _hop_check(f"{at}, from the empty state", qh, kh, vh, _empty_state(b, hq), scale,
                           empty=True)
    incoming = pa.play_attention_carry_plain(qh, k[:, hk:2 * hk].contiguous(),
                                             v[:, hk:2 * hk].contiguous(), *_empty_state(b, hq),
                                             scale)
    second, _ = _hop_check(f"{at}, from the other half's state", qh, kh, vh,
                           tuple(x.clone() for x in incoming), scale, empty=False)
    # no atomics: a second launch from the same state gives the same bits
    runs = [pa.play_attention_carry(qh, kh, vh, *(x.clone() for x in incoming), scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(*runs))
    log(f"  play_attention_carry {at}: a second launch bit-equal {equal}")
    if not equal:
        raise RuntimeError(f"kernel 5 is not deterministic at {label}")
    del runs
    checks = {**{f"{name} hop shape, empty state": c for name, c in checks.items()},
              **{f"{name} hop shape, second hop": c for name, c in second.items()}}
    o, m, l = _empty_state(b, hq)
    state = (o.clone(), m.clone(), l.clone())
    big = hq * hk > 2.5e7
    reps, plain_reps = (5, 1) if big else (20, 5)
    ms = cuda_time_ms(lambda: pa.play_attention_carry(qh, kh, vh, *state, scale), reps)
    plain_ms = cuda_time_ms(lambda: pa.play_attention_carry_plain(qh, kh, vh, o, m, l, scale),
                            plain_reps)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh[:, None], kh[:, None], vh[:, None], scale=scale), reps)
    flops, nbytes = pa.play_attention_carry_cost(b, hq, hk)
    bound, by = _bound(flops, nbytes)
    log(f"play_attention_carry {label}, 2-way ring hop B={b} Lq={hq} Lk={hk} on {smi}: "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, SDPA forward "
        f"{lib_ms:.3f} ms, bound {bound:.3f} ms ({by})")
    return dict(hop_shape=dict(B=b, Lq=hq, Lk=hk), hop_checks=checks, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, tflops=flops / ms / 1e9,
                bit_equal_rerun=equal)


# (label, N, H, W1, W2): the pyramids of the three stages of a 320x512
# window of 10 frames (level 0 is (N, H, W1, W1)), and a ragged one: W2 not a
# power of two, odd sizes, coordinates partly outside the rows
LOOKUP_SHAPES = (
    ("1/4", 10, 80, 128, 128),
    ("1/8", 10, 40, 64, 64),
    ("1/16", 10, 20, 32, 32),
    ("ragged", 3, 7, 45, 45),
)


def _device_ms(fn, name: str, reps: int, flush=None) -> float:
    """The device time of one launch of the kernels whose name holds `name`
    over `reps` calls of fn, by torch.profiler (the CUDA-event time of a
    short kernel also holds the host's time to issue each call). With
    `flush` (a device buffer larger than the L2), the buffer is overwritten
    before each call, so fn finds the L2 cold; the fill is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.add_(1)
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in hits) / 1e3
    # per launch the profiler saw: the first profile of a process may miss
    # launches, which divided by reps read short (3.1 us at 1/4, bf16)
    seen = sum(e.count for e in hits)
    if seen and seen != reps:
        log(f"  profiler: {seen} of {reps} launches of {name!r} seen")
    return total / seen if seen else None


def _lookup_fault(pyramid, coords_x, radius: int = 4):
    """A wrong lookup for the fault reading: the fractional weights swapped."""
    import torch

    outs = []
    for lvl, corr in enumerate(pyramid):
        w2 = corr.shape[-1]
        pos = (coords_x / 2.0**lvl)[..., None] + torch.arange(
            -radius, radius + 1, device=coords_x.device, dtype=torch.float32)
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.long()

        def tap(idx):
            vals = torch.gather(corr, -1, idx.clamp(0, w2 - 1))
            return torch.where((idx >= 0) & (idx < w2), vals, torch.zeros_like(vals))

        outs.append(tap(i0) * frac + tap(i0 + 1) * (1.0 - frac))
    return torch.cat(outs, dim=-1)


def _grid_sample_lookup(pyramid, grids):
    """The reference's route: one F.grid_sample per level (align_corners,
    zeros padding) over each pixel's row as a 1 x W image."""
    import torch.nn.functional as F

    return [F.grid_sample(corr.reshape(-1, 1, 1, corr.shape[-1]), g, mode="bilinear",
                          padding_mode="zeros", align_corners=True)
            for corr, g in zip(pyramid, grids)]


# (pyramid dtype, output dtype) of kernel 6, the main path's first (its
# record's times are this pair's at 1/4)
LOOKUP_DTYPES = (("bfloat16", "bfloat16"), ("float32", "float32"), ("bfloat16", "float32"),
                 ("float32", "bfloat16"))


def phase_lookup(smi: str):
    """Kernel 6 against the port's lookup (its plain version, cast to the
    output dtype) at the three stages' pyramids and a ragged one, for each
    pair of LOOKUP_DTYPES, with a fault reading (the fractional weights
    swapped); times of kernel, plain lookup and four grid_samples (on the
    pyramid widened to f32), device times with the L2 warm (the same inputs
    call after call) and flushed, and the bound from the bytes at the real
    element sizes."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup

    def us(x):
        return "not measured" if x is None else f"{x * 1e3:.1f} us"

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, five times the L2
    rows = []
    for label, n, h, w1, w2 in LOOKUP_SHAPES:
        f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
        f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
        pyr32 = [c.reshape(n, h, w1, -1).contiguous() for c in build_corr_pyramid(f1, f2, 4)]
        # coordinates as the model makes them (pixel column minus a
        # disparity), some past either end of the row
        cols = torch.arange(w1, device="cuda", dtype=torch.float32)
        coords = cols - torch.rand(n, h, w1, generator=gen, device="cuda") * 0.4 * w2
        if label == "ragged":
            coords = torch.rand(n, h, w1, generator=gen, device="cuda") * (w2 + 24) - 12
        for pyr_name, out_name in LOOKUP_DTYPES:
            pyr_dtype, out_dtype = getattr(torch, pyr_name), getattr(torch, out_name)
            # the bf16 pyramid as the model stores it: the f32 volume rounded
            pyramid = [c.to(pyr_dtype) for c in pyr32]
            got = kl.corr_lookup_kernel(pyramid, coords, out_dtype=out_dtype)
            want = corr_lookup(pyramid, coords).to(out_dtype)
            fault = _lookup_fault(pyramid, coords).to(out_dtype)
            torch.cuda.synchronize()
            at = f"{label} {pyr_name} -> {out_name}"
            # the kernel repeats the plain version's operations in its order
            # with round-to-nearest intrinsics and casts as .to() does: a few
            # f32 ulps at most, 2^-21 of the largest |value| and 2^-23 of the
            # mean |value| (a bf16 output one ulp off reads 2^-9 or more)
            check = _agreement(at, "corr_lookup", got, want, fault,
                               2**-21 * want.float().abs().max().item(),
                               2**-23 * want.float().abs().mean().item())
            check["bit_equal"] = bool(torch.equal(got, want))
            if not check["bit_equal"]:
                raise RuntimeError(f"corr_lookup at {at} is within its limits but not bit-equal "
                                   "to the plain lookup")
            # grid_sample takes its grid in its input's dtype, and a bf16 grid
            # cannot hold the positions (it reads up to ~0.7 off): the four
            # calls run on the pyramid's values widened to f32 beforehand
            wide, grids = [c.float() for c in pyramid], []
            for lvl, corr in enumerate(pyramid):
                w = corr.shape[-1]
                pos = (coords / 2.0**lvl).reshape(-1, 1, 1) + torch.arange(-4, 5, device="cuda")
                gx = 2.0 * pos / (w - 1) - 1.0
                grids.append(torch.stack([gx, torch.zeros_like(gx)], dim=-1))
            lib = torch.cat([x.reshape(n, h, w1, 9) for x in _grid_sample_lookup(wide, grids)], -1)
            lib_err = (lib.float() - want.float()).abs().max().item()

            def kernel():
                return kl.corr_lookup_kernel(pyramid, coords, out_dtype=out_dtype)

            ms = cuda_time_ms(kernel, 50)
            plain_ms = cuda_time_ms(lambda: corr_lookup(pyramid, coords).to(out_dtype), 20)
            lib_ms = cuda_time_ms(lambda: _grid_sample_lookup(wide, grids), 20)
            device_ms = _device_ms(kernel, "corr_lookup", 20)
            cold_ms = _device_ms(kernel, "corr_lookup", 20, flush=flush)
            nbytes = kl.corr_lookup_bytes(pyramid, coords, out_dtype=out_dtype)
            bound, by = _bound(0.0, nbytes)
            pyr_bytes = float(sum(c.numel() * c.element_size() for c in pyramid))
            log(f"corr_lookup {at} N={n} H={h} W1={w1} W2={w2} on {smi}: kernel "
                f"{ms * 1e3:.1f} us per call ({nbytes / ms / 1e6:.1f} GB/s of the "
                f"{nbytes / 1e6:.2f} MB it must move); device time {us(device_ms)} with the L2 "
                f"warm, {us(cold_ms)} flushed; plain {plain_ms * 1e3:.1f} us, 4 x grid_sample "
                f"{lib_ms * 1e3:.1f} us (max |diff| {lib_err:.2e} from the plain lookup), bound "
                f"{bound * 1e3:.2f} us ({by}); the whole pyramid is {pyr_bytes / 1e6:.1f} MB "
                f"({pyr_bytes / H100_BYTES_PER_S * 1e6:.1f} us); bit-equal {check['bit_equal']}")
            rows.append(dict(shape=at, N=n, H=h, W1=w1, W2=w2, checks={"out": check}, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             gb_per_s=nbytes / ms / 1e6, device_ms=device_ms,
                             device_cold_ms=cold_ms, grid_sample_max_abs_diff=lib_err))
            del pyramid, wide, got, want, fault, grids, lib
        del f1, f2, pyr32
    instances = _lookup_instances(flush, smi)
    del flush
    torch.cuda.empty_cache()
    return rows, instances


# kernel 6's instances beyond the shipped radius 4 and 4 levels: the radii
# and level counts PPMStereoConfig's corr_radius and corr_levels take on the
# main path's 1/4 pyramid (configuration B of phase config: radius 3, 3 levels)
LOOKUP_INSTANCES = tuple((r, n) for r in (2, 3, 4) for n in (3, 4))
# the device times of the shipped instance (radius 4, 4 levels, bf16 in and
# out) at the 320x512 1/4 pyramid when the kernel took radius 4 only, in ms:
# the L2 warm and flushed (PERF.md §6)
LOOKUP_RADIUS4_ONLY_MS = (0.0138, 0.0198)


def _lookup_instances(flush, smi: str) -> list:
    """Kernel 6 at each of LOOKUP_INSTANCES on the 320x512 1/4 pyramid, bf16
    and f32 (pyramid and output of one dtype), bit-equal to the plain lookup
    required; device times with the L2 warm and flushed."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup

    def us(x):
        return "not measured" if x is None else f"{x * 1e3:.1f} us"

    _, n, h, w1, w2 = LOOKUP_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
    f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
    pyr32 = [c.reshape(n, h, w1, -1).contiguous() for c in build_corr_pyramid(f1, f2, 4)]
    cols = torch.arange(w1, device="cuda", dtype=torch.float32)
    coords = cols - torch.rand(n, h, w1, generator=gen, device="cuda") * 0.4 * w2
    out = []
    for radius, levels in LOOKUP_INSTANCES:
        for dtype in (torch.bfloat16, torch.float32):
            pyramid = [c.to(dtype) for c in pyr32[:levels]]
            got = kl.corr_lookup_kernel(pyramid, coords, radius, out_dtype=dtype)
            want = corr_lookup(pyramid, coords, radius).to(dtype)
            equal = bool(torch.equal(got, want))

            def kernel():
                return kl.corr_lookup_kernel(pyramid, coords, radius, out_dtype=dtype)

            warm = _device_ms(kernel, "corr_lookup", 20)
            cold = _device_ms(kernel, "corr_lookup", 20, flush=flush)
            nbytes = kl.corr_lookup_bytes(pyramid, coords, radius, out_dtype=dtype)
            bound, _ = _bound(0.0, nbytes)
            at = f"radius {radius}, {levels} levels, {str(dtype)[6:]}"
            note = ""
            if (radius, levels, dtype) == (4, 4, torch.bfloat16):
                note = (f" (the radius-4-only kernel: {LOOKUP_RADIUS4_ONLY_MS[0] * 1e3:.1f} us "
                        f"warm, {LOOKUP_RADIUS4_ONLY_MS[1] * 1e3:.1f} us flushed)")
            log(f"corr_lookup instance {at} at 320x512 1/4 on {smi}: device time {us(warm)} "
                f"with the L2 warm, {us(cold)} flushed{note}; bound {bound * 1e3:.2f} us; "
                f"bit-equal {equal}")
            if not equal:
                raise RuntimeError(f"corr_lookup at {at} is not bit-equal to the plain lookup")
            out.append(dict(radius=radius, levels=levels, dtype=str(dtype)[6:],
                            device_ms=warm, device_cold_ms=cold, bound_ms=bound,
                            bit_equal=equal))
    return out


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least milliseconds for this work on an H100 SXM, and what bounds it."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
        model = ppm_stereo.PPMStereo(ppm_stereo.PPMStereoConfig(mixed_precision=False), iters=4,
                                     test_mode=True)
        load_flax_params(model, flat)
        model.to(dev).eval()
        if run == "fault":
            ppm_stereo.play_attention = lambda q, k, v, scale: pa.play_attention(q, k, v, 2 * scale)
        try:
            with torch.no_grad():
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
    return dict(err=err, fault=fault, cuda=outs["cuda"], left=left.numpy(),
                right=right.numpy())


# train small parity: gradients are compared tensor by tensor, by the norm
# of the difference over the norm of the tensor's gradient, over the tensors
# whose largest |gradient| is at least 1e-4 of the model's largest (the rest
# are biases ahead of an instance norm, whose true gradient is 0 and which
# read rounding noise); one-element tensors are read apart (see
# TRAIN_SCALAR_GRAD_TOL)
SIGNIFICANT_GRAD = 1e-4


def significant(grads: dict) -> set:
    """The names of the tensors whose largest |gradient| is at least
    SIGNIFICANT_GRAD of the largest over all tensors."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items() if float(g.abs().max()) >= SIGNIFICANT_GRAD * top}


def grad_agreement(got: dict, want: dict, encoders: tuple = ()) -> dict:
    """The worst ||got - want|| / ||want|| over the significant tensors of
    `want`, apart for tensors of more than one element ("tensor") and of
    one ("scalar"), and for the tensors named with an `encoders` prefix
    ("encoder"): {group: (reading, name)}."""
    worst = {"tensor": (0.0, ""), "scalar": (0.0, ""), "encoder": (0.0, "")}
    for name in significant(want):
        w = want[name]
        rel = float((got[name] - w).norm() / w.norm())
        group = ("encoder" if name.startswith(encoders) else
                 "scalar" if w.numel() == 1 else "tensor")
        worst[group] = max(worst[group], (rel, name))
    return worst


def _one_train_step(dev: str, flat, batch: dict, doubled: int | None = None, mesh=None):
    """One train_step of a fresh f32 PPMStereo (2 iterations) from `flat`
    on `dev`: (loss, the gradients the optimiser reads, parameters after
    the update, optimiser), the tensors on the CPU. `doubled` (0, 1, 2): a
    wrong backward, with the play attention's dq, dk or dv doubled. With a
    `mesh`, `batch` is this rank's block and the step is data-parallel
    over the mesh's data axis (the loss the global batch's, the gradients
    summed)."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
    from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState
    from ppmstereo_tpu_torch.train.step import to_device, train_step
    from ppmstereo_tpu_torch.utils.weights import load_flax_params

    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=2, test_mode=False,
                      mesh=mesh)
    load_flax_params(model, flat)
    model.to(dev)
    state = TrainState(model, TrainOptimizer(model, num_steps=1000), True,
                       replica_group=None if mesh is None else mesh.replica_group)
    grads = {}
    names = {id(p): n for n, p in model.named_parameters()}
    optimizer_step = state.optimizer.step

    def read_then_step():  # the gradients the optimiser reads (summed over a mesh)
        for g, p in zip(state.optimizer.gradients(),
                        (p for group in state.optimizer.groups for p in group)):
            grads[names[id(p)]] = g.detach().float().cpu().clone()
        return optimizer_step()

    state.optimizer.step = read_then_step
    # the wrong backward doubles one gradient in the backward that `dev`
    # runs: the card's kernels or the CPU's plain version
    backward = pa.play_attention_bwd_plain if dev == "cpu" else pa.play_attention_bwd
    if doubled is not None:
        setattr(pa, backward.__name__, lambda *a: tuple(
            2 * g if i == doubled else g for i, g in enumerate(backward(*a))))
    try:
        state, metrics = train_step(state, to_device(batch, torch.device(dev)))
        loss = float(metrics["loss"])
    finally:
        setattr(pa, backward.__name__, backward)
    params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    return loss, grads, params, state.optimizer


def phase_train_small_parity():
    """One f32 train step on the card against the port's CPU path (which
    tests/test_torch_train.py holds against jax.value_and_grad), from the
    anchor, on a synthetic clip of 3 frames at 64x128; and the card's
    step with a wrong backward (dk doubled), which must fail the tensor
    limit, and with dv doubled, which must fail the blends' limit."""
    import torch

    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset
    from ppmstereo_tpu_torch.train.state import onecycle_lr
    from ppmstereo_tpu_torch.utils.weights import load_npz

    torch.set_num_threads(8)
    sample = SyntheticStereoDataset(num_seqs=1, sample_len=3, height=64, width=128, seed=0)[0]
    batch = {"left": sample["img"][None, :, 0], "right": sample["img"][None, :, 1],
             "disparity": sample["disp"][None, :, 0], "valid": sample["valid"][None, :, 0]}
    flat = load_npz(ANCHOR)
    runs = {run: _one_train_step(dev, flat, batch, doubled=doubled)
            for run, dev, doubled in (("cpu", "cpu", None), ("cuda", "cuda", None),
                                      ("fault", "cuda", 1), ("fault_dv", "cuda", 2))}
    (l_cpu, g_cpu, p_cpu, opt), (l_cuda, g_cuda, p_cuda, _) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_cuda - l_cpu) / abs(l_cpu)
    grad = grad_agreement(g_cuda, g_cpu)
    fault = grad_agreement(runs["fault"][1], g_cpu)
    fault_dv = grad_agreement(runs["fault_dv"][1], g_cpu)
    # the update of Adam's first step is +-lr wherever the gradient is not
    # tiny: count the elements whose update differs by more than lr / 2
    lr0 = onecycle_lr(0, opt.num_steps, opt.lr)
    n_total = sum(p.numel() for p in p_cpu.values())
    n_off = sum(int(((p_cuda[n] - p).abs() > lr0 / 2).sum()) for n, p in p_cpu.items())
    off_share = n_off / n_total
    log(f"train step (1, 3, 64, 128), f32, 2 iterations: loss cpu {l_cpu:.6f} cuda {l_cuda:.6f} "
        f"(rel {loss_rel:.2e}, tol {TRAIN_LOSS_TOL}); gradient norm ratio at worst "
        f"{grad['tensor'][0]:.3e} ({grad['tensor'][1]}; tol {TRAIN_GRAD_TOL}), one-element "
        f"{grad['scalar'][0]:.3e} ({grad['scalar'][1]}; tol {TRAIN_SCALAR_GRAD_TOL}); the card "
        f"with a wrong backward (dk doubled) reads {fault['tensor'][0]:.3e} "
        f"({fault['tensor'][1]}), one-element {fault['scalar'][0]:.3e}; with dv doubled "
        f"{fault_dv['tensor'][0]:.3e}, one-element {fault_dv['scalar'][0]:.3e} "
        f"({fault_dv['scalar'][1]}); updated parameters: "
        f"{off_share:.2e} of {n_total} elements off by more than lr/2 = {lr0 / 2:.2e} "
        f"(tol {TRAIN_UPDATE_TOL})")
    if not (loss_rel <= TRAIN_LOSS_TOL and grad["tensor"][0] <= TRAIN_GRAD_TOL
            and grad["scalar"][0] <= TRAIN_SCALAR_GRAD_TOL and off_share <= TRAIN_UPDATE_TOL):
        raise RuntimeError("the card's train step disagrees with the CPU path")
    if not fault["tensor"][0] > TRAIN_GRAD_TOL:
        raise RuntimeError("the gradient limit does not catch a wrong backward")
    if not fault_dv["scalar"][0] > TRAIN_SCALAR_GRAD_TOL:
        raise RuntimeError("the blend limit does not catch a wrong dv")
    return dict(loss_rel=loss_rel, grad=grad, fault=fault, fault_dv=fault_dv,
                update_off=off_share)


def phase_main(smi: str):
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
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
    pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
    out = pred({"stereo_video": video})
    launches = pa.play_attention.launches
    lookup_launches = kl.corr_lookup_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    disp = out["disparity"]
    expected_shape = (CLIP_FRAMES, HEIGHT, WIDTH, 1)
    if disp.shape != expected_shape or not np.isfinite(disp).all():
        raise RuntimeError(f"disparity has shape {disp.shape} (want {expected_shape}) "
                           f"or non-finite values")
    # kernels 1 and 6: one launch each per iteration
    expected = LAUNCHES_PER_WINDOW * len(window_s)
    if launches != expected or lookup_launches != expected:
        raise RuntimeError(f"play_attention launched {launches} times and corr_lookup "
                           f"{lookup_launches}, expected {expected} each")
    epe = float(np.abs(disp[..., 0] - gt).mean())
    if not epe <= EPE_BOUND_PX:
        raise RuntimeError(f"EPE {epe:.3f} px exceeds {EPE_BOUND_PX} px")
    steady = window_s[1:] or window_s
    log(f"main path {CLIP_FRAMES}x{HEIGHT}x{WIDTH}, window {WINDOW}, iters {ITERS}: "
        f"{len(window_s)} windows, seconds per window {[round(s, 3) for s in window_s]} "
        f"(after the first: mean {sum(steady) / len(steady):.3f}s), "
        f"peak memory {peak_gb:.2f} GB, play launches {launches} and lookup launches "
        f"{lookup_launches} ({LAUNCHES_PER_WINDOW} per window each), EPE {epe:.3f} px on {smi}")
    pred.predictor.window_fn = window_fn
    plain_lookup = _window_with_plain_lookup(pred, video, smi)
    return dict(launches=launches, lookup_launches=lookup_launches, window_s=window_s,
                peak_gb=peak_gb, epe=epe, plain_lookup=plain_lookup,
                pred=pred, video=video, disparity=disp, gt=gt)


def _window_with_plain_lookup(pred, video, smi: str,
                              launches_per_window: int = LAUNCHES_PER_WINDOW) -> dict:
    """One steady window (frames 5-14) through kernel 6, then with the plain
    lookup (ops/corr.py::corr_lookup cast to the model's dtype) patched into
    the model in its place, then through kernel 6 again: the disparities
    must be equal bit for bit (the kernel's bf16 features are the plain
    lookup's, rounded alike). Kernel 6 must launch `launches_per_window`
    times in each kernel run."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.models import ppm_stereo
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    clip = torch.from_numpy(video[5:5 + WINDOW]).cuda()
    run = pred.predictor._run_window
    outs, launches = {}, {}
    for name in ("kernel", "plain", "kernel again"):
        kl.corr_lookup_kernel.launches = 0
        if name == "plain":
            ppm_stereo.corr_lookup_kernel = (
                lambda pyramid, x, radius, out_dtype: corr_lookup(pyramid, x, radius).to(out_dtype))
        try:
            outs[name] = run(clip[:, 0], clip[:, 1])[0]
        finally:
            ppm_stereo.corr_lookup_kernel = kl.corr_lookup_kernel
        torch.cuda.synchronize()
        launches[name] = kl.corr_lookup_kernel.launches
    diff = (outs["kernel"] - outs["plain"]).abs().max().item()
    equal = bool(torch.equal(outs["kernel"], outs["plain"]))
    rerun = bool(torch.equal(outs["kernel"], outs["kernel again"]))
    log(f"one steady window through kernel 6 and with the plain lookup on {smi}: disparity "
        f"bit-equal {equal} (max |diff| {diff:.3e} px); kernel 6 launches {launches}; the "
        f"kernel's run repeated bit-equal {rerun}")
    if launches != {"kernel": launches_per_window, "plain": 0,
                    "kernel again": launches_per_window}:
        raise RuntimeError(f"kernel 6 launches per window {launches}")
    if not equal:
        raise RuntimeError(f"the window's disparity through kernel 6 differs from the plain "
                           f"lookup's by up to {diff:.3e} px")
    return dict(bit_equal=equal, max_abs_diff=diff, rerun_bit_equal=rerun)


# the space-sharded path: RING_RANKS processes on the one card, one gloo
# group; every collective and the whole phase bounded by RING_TIMEOUT_S
RING_RANKS = 2
RING_TIMEOUT_S = 600
# In bf16 at 320x512 the ring and the single-process run differ by up to
# 0.93 px of disparity (mean 5.8e-3 px; an H100), as much as a dropped carry
# moves the output (1.24 px, mean 6.9e-3): the anchor's play blends are
# small (0.023 at 1/4), so the play step moves the disparity less than
# bf16's own divergence through 30 iterations does, and no disparity limit
# fits between the two. So at the main path's size the ring is held play
# step by play step: each ringed play's output against the unsharded play
# (kernel 1) on the same inputs, with kernel 1's limits (see
# _ring_play_readings), over one window, and a dropped carry as the fault.
# The whole run is also held to the single-process EPE (RING_EPE_TOL px),
# and the disparity limit (RING_SMALL_TOL px) to the small parity's clip in
# f32, against the card's single-process f32 output.
RING_EPE_TOL = 0.01
RING_SMALL_TOL = 1e-3


def _checked_plays(readings: list):
    """Patch `PPMUpdateLoop._play` so that each play step that rings also
    runs unsharded (kernel 1 over this process's copy of the whole rows) on
    the same inputs; `readings` gets each such call's max and mean
    |ring - unsharded| and kernel 1's limits for them: 2^-7 max|out| +
    2^-8 max|v| and 2^-8 mean|out| (bf16 outputs; see phase_kernels).
    Returns the original method."""
    import torch
    import torch.distributed as dist

    from ppmstereo_tpu_torch.models.ppm_stereo import PPMUpdateLoop

    play = PPMUpdateLoop._play

    def checked(self, query_pe, key_aug, value, idx, score_norm):
        out = play(self, query_pe, key_aug, value, idx, score_norm)
        group, h = self.space_group, query_pe.shape[2]
        if group is None or h % dist.get_world_size(group):
            return out  # this play step did not ring
        self.space_group = None
        try:
            want = play(self, query_pe, key_aug, value, idx, score_norm).float()
        finally:
            self.space_group = group
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        v_max = value[rows, idx].to(torch.bfloat16).float().abs().max().item()
        diff = (out.float() - want).abs()
        readings.append(dict(rows=h, max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                             tol=2**-7 * want.abs().max().item() + 2**-8 * v_max,
                             mean_tol=2**-8 * want.abs().mean().item()))
        return out

    PPMUpdateLoop._play = checked
    return play


def _timed_windows(pred, window_s: list):
    """Wrap the predictor's window function to record each window's seconds."""
    import torch

    window_fn = pred.predictor.window_fn

    def timed_window(left, right):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = window_fn(left, right)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
        return out

    pred.predictor.window_fn = timed_window
    return window_fn


def _drop_carry(ra):
    """The fault: every hop of the ring starts from the empty state, so a
    block attends over the keys of its last hop only (a dropped carry)."""
    carry = ra.play_attention_carry
    ra.play_attention_carry = lambda q, k, v, o, m, l, scale: carry(
        q, k, v, o.zero_(), m.fill_(ra.NEG_INF), l.zero_(), scale)
    return carry


def _ring_child(rank: int, world: int, video, fault_frames: int, small_left, small_right):
    """One process of the ring phase: the main path's predictor with its
    play steps ringed over a space mesh of all processes (counted); then
    the clip's first `fault_frames` frames (a window and its tail window)
    twice with each ringed play step held against the unsharded play on its
    inputs, sound and with every hop's incoming state dropped (the fault);
    then the small parity's f32 forward, sound and with the fault."""
    from datetime import timedelta

    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig, PPMUpdateLoop
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.parallel import ring_attention as ra
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    torch.cuda.set_device(0)
    mesh = make_mesh(MeshSpec(space=world), timeout=timedelta(seconds=RING_TIMEOUT_S))
    pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS,
                     params=load_npz(ANCHOR), mesh=mesh)
    window_s: list = []
    window_fn = _timed_windows(pred, window_s)
    torch.cuda.reset_peak_memory_stats()
    pa.play_attention.launches = pa.play_attention_carry.launches = 0
    kl.corr_lookup_kernel.launches = ra.shift.messages = ra.shift.bytes = 0
    t0 = time.perf_counter()
    out = pred({"stereo_video": video})
    seconds = time.perf_counter() - t0
    counts = dict(play_attention_carry=pa.play_attention_carry.launches,
                  play_attention_fwd=pa.play_attention.launches,
                  corr_lookup=kl.corr_lookup_kernel.launches,
                  messages=ra.shift.messages, bytes=ra.shift.bytes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pred.predictor.window_fn = window_fn
    carry_window = _profiled_carry_window(pred, video)

    plays = {"sound": [], "fault": []}
    replay_windows: list = []  # the clip's first frames: a window and its tail
    play = _checked_plays(plays["sound"])
    try:
        window_fn = _timed_windows(pred, replay_windows)
        pred({"stereo_video": video[:fault_frames]})
        pred.predictor.window_fn = window_fn
        PPMUpdateLoop._play = play
        _checked_plays(plays["fault"])
        carry = _drop_carry(ra)
        try:
            fault = pred({"stereo_video": video[:fault_frames]})["disparity"]
        finally:
            ra.play_attention_carry = carry
    finally:
        PPMUpdateLoop._play = play

    small = {}
    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=4, test_mode=True, mesh=mesh)
    load_flax_params(model, load_npz(ANCHOR))
    model.cuda().eval()
    for run in ("sound", "fault"):
        carry = _drop_carry(ra) if run == "fault" else ra.play_attention_carry
        try:
            with torch.no_grad():
                disp, _ = model(torch.from_numpy(small_left).cuda(),
                                torch.from_numpy(small_right).cuda())
        finally:
            ra.play_attention_carry = carry
        small[run] = disp.cpu().numpy()
    return dict(disparity=out["disparity"], fault=fault, plays=plays,
                replay_windows=len(replay_windows), window_s=window_s,
                seconds=seconds, counts=counts, peak_gb=peak_gb, small=small,
                carry_window=carry_window,
                staged=ra.host_staged(mesh.groups["space"], torch.device("cuda")))


CARRY_KERNEL = "play_attention_fwd_kernel<2>"  # kernel 5's instance, as the profiler names it


def kernel_device_ms(events, fragment: str) -> dict:
    """The device time and launches of the kernels whose name holds
    `fragment` among profiler `events` (`key_averages()`); device_ms is None
    when no event of the device was recorded at all (not measured), and the
    function raises when there were some but none of these kernels."""
    import torch

    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    hits = [e for e in on_device if fragment in e.key]
    if on_device and not hits:
        raise RuntimeError(f"the profiler recorded {len(on_device)} device kernels, none of them "
                           f"{fragment}")
    return dict(kernels=sum(e.count for e in hits),
                device_ms=sum(e.self_device_time_total for e in hits) / 1e3 if hits else None)


def _profiled_carry_window(pred, video) -> dict:
    """One steady window of the ring's predictor again under
    torch.profiler, kernel 5's count set to 0 just before: its launches and
    device time in that window on this rank. Every rank runs it (a ring
    needs them all); the ranks time-share the card, so a hop may wait
    behind the other rank's work inside its measured time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    frames = torch.from_numpy(video[5:5 + WINDOW]).cuda()
    torch.cuda.synchronize()
    pa.play_attention_carry.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred.predictor._run_window(frames[:, 0], frames[:, 1])
        torch.cuda.synchronize()
    return dict(launches=pa.play_attention_carry.launches,
                **kernel_device_ms(prof.key_averages(), CARRY_KERNEL))


def _play_shares(calls: list, worst) -> dict:
    """`worst` (max or min) over the play steps `calls` of each reading as
    a share of its limit."""
    return dict(calls=len(calls), max_share=worst(x["max_abs_err"] / x["tol"] for x in calls),
                mean_share=worst(x["mean_abs_err"] / x["mean_tol"] for x in calls),
                max_abs_err=worst(x["max_abs_err"] for x in calls),
                mean_abs_err=worst(x["mean_abs_err"] for x in calls))


def phase_ring(main_run: dict, small_run: dict, smi: str):
    """The main path with its play steps as the ring over RING_RANKS
    processes sharing the card (gloo, host-staged): kernel 5's launches,
    the disparity and EPE against the single-process main run; each ringed
    play step of the clip's first window (and its tail) against the
    unsharded play on the same inputs; and the small parity's f32 clip through the ring against the
    single-process f32 output; a dropped carry as the fault of both."""
    import numpy as np

    from ppmstereo_tpu_torch.models.inference import window_trim_bounds
    from ppmstereo_tpu_torch.parallel.launch import run_group

    t0 = time.perf_counter()
    results = run_group(_ring_child, RING_RANKS, (main_run["video"], WINDOW, small_run["left"],
                                                   small_run["right"]),
                        timeout_s=RING_TIMEOUT_S, threads=4)
    wall_s = time.perf_counter() - t0
    ref, gt = main_run["disparity"], main_run["gt"]
    keep = WINDOW - window_trim_bounds(0, WINDOW, WINDOW, WINDOW // 2)[1]
    n_windows = len(main_run["window_s"])
    want_carry = RING_RANKS * LAUNCHES_PER_WINDOW * n_windows
    want_lookup = LAUNCHES_PER_WINDOW * n_windows  # every rank runs the whole window
    # one 1/4-stage message: q bf16, o f32, m and l f32 of this rank's rows
    rows_q = WINDOW * (HEIGHT // 4 // RING_RANKS) * (WIDTH // 4)
    quarter_bytes = rows_q * (128 * 2 + 128 * 4 + 8)
    readings = []
    for rank, res in enumerate(results):
        disp, fault = res["disparity"], res["fault"]
        diff = np.abs(disp - ref)
        f_diff = np.abs(fault[:keep] - ref[:keep])
        c = res["counts"]
        small = {run: float(np.abs(d - small_run["cuda"]).max())
                 for run, d in res["small"].items()}
        # the ringed play steps' readings as shares of their limits: the
        # sound run's worst and the fault's least
        plays = {run: _play_shares(res["plays"][run], worst)
                 for run, worst in (("sound", max), ("fault", min))}
        plays["expected_calls"] = LAUNCHES_PER_WINDOW * res["replay_windows"]
        r = dict(rank=rank, max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
                 small_max_abs_diff=small["sound"], small_fault_max_abs_diff=small["fault"],
                 fault_max_abs_diff=float(f_diff.max()), fault_mean_abs_diff=float(f_diff.mean()),
                 epe=float(np.abs(disp[..., 0] - gt).mean()),
                 first_window_epe=float(np.abs(disp[:keep, ..., 0] - gt[:keep]).mean()),
                 fault_first_window_epe=float(np.abs(fault[:keep, ..., 0] - gt[:keep]).mean()),
                 plays=plays, window_s=res["window_s"],
                 seconds=res["seconds"], peak_gb=res["peak_gb"], counts=c,
                 carry_window=res["carry_window"],
                 bytes_per_hop=c["bytes"] / max(c["messages"], 1))
        readings.append(r)
        log(f"ring rank {rank} of {RING_RANKS} on one card ({smi}), transport "
            f"{'gloo, host-staged' if res['staged'] else 'device'}: windows "
            f"{[round(x, 3) for x in res['window_s']]} s, {res['seconds']:.2f} s in the "
            f"predictor, peak {res['peak_gb']:.2f} GB; launches kernel 5 "
            f"{c['play_attention_carry']} (expected {want_carry}), kernel 1 "
            f"{c['play_attention_fwd']} (expected 0), kernel 6 {c['corr_lookup']} (expected "
            f"{want_lookup}); {c['messages']} messages, "
            f"{c['bytes'] / 1e9:.3f} GB sent, {r['bytes_per_hop'] / 1e6:.2f} MB per hop on average "
            f"({quarter_bytes / 1e6:.2f} MB at 1/4); max |disparity - single process| "
            f"{r['max_abs_diff']:.3e} px (mean {r['mean_abs_diff']:.3e}), "
            f"EPE {r['epe']:.4f} px (single process {main_run['epe']:.4f}); every hop's carry "
            f"dropped, first window: {r['fault_max_abs_diff']:.3e} px (mean "
            f"{r['fault_mean_abs_diff']:.3e}), EPE of its {keep} kept frames "
            f"{r['fault_first_window_epe']:.4f} px (sound ring {r['first_window_epe']:.4f}); "
            f"f32 small clip (1, 5, 64, 128): max |disparity "
            f"- single process| {small['sound']:.3e} px (tol {RING_SMALL_TOL}), with the carry "
            f"dropped {small['fault']:.3e} px")
        cw = r["carry_window"]
        log(f"  ring rank {rank}, one steady window under torch.profiler: kernel 5 launched "
            f"{cw['launches']} times (expected {RING_RANKS * LAUNCHES_PER_WINDOW}), "
            f"{cw['kernels']} seen by the profiler, device time "
            + ("not measured (the profiler saw no device time)" if cw["device_ms"] is None
               else f"{cw['device_ms']:.3f} ms per window and rank") + f", on {smi}")
        sound, dropped = plays["sound"], plays["fault"]
        log(f"  ring rank {rank}, play steps of the first {WINDOW} frames against the unsharded "
            f"play on the same inputs: {sound['calls']} ringed calls (expected "
            f"{plays['expected_calls']}), at worst max_abs_err "
            f"{sound['max_abs_err']:.3e} and mean_abs_err {sound['mean_abs_err']:.3e}, "
            f"{sound['max_share']:.3f} and {sound['mean_share']:.3f} of their limits; every "
            f"hop's carry dropped: {dropped['calls']} calls, at least {dropped['max_share']:.1f} "
            f"and {dropped['mean_share']:.1f} times their limits (max_abs_err "
            f"{dropped['max_abs_err']:.3e}, mean_abs_err {dropped['mean_abs_err']:.3e})")
    log(f"ring phase: {wall_s:.1f} s wall with process start; the times are "
        f"{RING_RANKS} processes sharing one card, not a scaling result")
    for r, res in zip(readings, results):
        disp = res["disparity"]
        if disp.shape != ref.shape or not np.isfinite(disp).all():
            raise RuntimeError(f"ring rank {r['rank']}: disparity of shape {disp.shape} "
                               f"(want {ref.shape}) or non-finite")
        if not res["staged"]:
            raise RuntimeError("the ring phase expects a gloo group staged through the host")
        if (r["counts"]["play_attention_carry"] != want_carry or r["counts"]["play_attention_fwd"]
                or r["counts"]["corr_lookup"] != want_lookup):
            raise RuntimeError(f"ring rank {r['rank']}: launches {r['counts']}, expected "
                               f"{want_carry} of kernel 5, none of kernel 1 and {want_lookup} "
                               "of kernel 6")
        cw = r["carry_window"]
        if cw["launches"] != RING_RANKS * LAUNCHES_PER_WINDOW or (
                cw["device_ms"] is not None and cw["kernels"] != cw["launches"]):
            raise RuntimeError(f"ring rank {r['rank']}: the profiled window launched kernel 5 "
                               f"{cw['launches']} times and the profiler saw {cw['kernels']}, "
                               f"expected {RING_RANKS * LAUNCHES_PER_WINDOW}")
        if not abs(r["epe"] - main_run["epe"]) <= RING_EPE_TOL:
            raise RuntimeError(f"ring rank {r['rank']}: EPE {r['epe']:.4f} px against the "
                               f"single process's {main_run['epe']:.4f} px")
        if r["plays"]["sound"]["calls"] != r["plays"]["expected_calls"] or not (
                r["plays"]["sound"]["max_share"] <= 1 and r["plays"]["sound"]["mean_share"] <= 1):
            raise RuntimeError(f"ring rank {r['rank']}: the ringed play steps disagree with the "
                               f"unsharded play: {r['plays']['sound']}")
        if not (r["plays"]["fault"]["max_share"] > 1 and r["plays"]["fault"]["mean_share"] > 1):
            raise RuntimeError(f"the play-step limits do not catch a dropped carry: "
                               f"{r['plays']['fault']}")
        if not r["small_max_abs_diff"] <= RING_SMALL_TOL:
            raise RuntimeError(f"ring rank {r['rank']} differs from the single-process f32 run "
                               f"by {r['small_max_abs_diff']:.3e} px")
        if not r["small_fault_max_abs_diff"] > RING_SMALL_TOL:
            raise RuntimeError("the ring's disparity limit does not catch a dropped carry")
    return dict(readings=readings, wall_s=wall_s,
                launches=readings[0]["counts"]["play_attention_carry"],
                carry_window_ms=readings[0]["carry_window"]["device_ms"],
                lookup_launches=readings[0]["counts"]["corr_lookup"])


# the seq axis: SEQ_RANKS processes on the one card (gloo, host-staged), as
# the ring phase runs; each window of the main clip whose frames divide over
# the axis spreads them (the windows of 10: 5 + 5 frames), the tail of 5
# runs whole on every process. Then the small parity's clip, cut to
# SEQ_SMALL_FRAMES frames (a length that divides), in f32: under seq 2
# against the card's single-process f32 output at the ring's limit
# (RING_SMALL_TOL), which each planted fault (SEQ_FAULTS) must exceed; and
# under seq x space = 2 x 2 (4 processes) play step by play step, as the ring
# phase holds the ring: each ringed play against the unsharded play (kernel
# 1) on the same inputs at kernel 1's limits. The ring's disparity is not
# held there: on this clip the space-2 ring alone reads 2.2e-3 px against
# the single process on an H100 (the CPU 1.8e-4; on the ring phase's
# 5-frame clip 6.7e-6), and seq x space 2.1e-3 px against that ring, where
# the CPU reads 8.6e-6 and seq 2 alone 6.7e-6 on the card (not explained
# yet); those distances are printed. The main run is held to the
# single-process main run at the strict modes' limits.
SEQ_RANKS = 2
SEQ_TIMEOUT_S = 600
SEQ_SMALL_FRAMES = 4
SEQ_SMALL_ITERS = 4  # plays: 2 + 2 + 4, every one ringed under seq x space
SEQ_FAULTS = ("zero_halos", "ungathered_bank")


def _zero_halos(sharding):
    """The fault: every time halo's frames read as zeros (the messages still
    go, so the processes stay in step)."""
    import torch

    halo = sharding.FrameShard.halo

    def zeroed(self, x, h):
        out = halo(self, x, h)
        edge = torch.zeros_like(out[:, :h])
        return torch.cat([edge, out[:, h: out.shape[1] - h], edge], dim=1)

    sharding.FrameShard.halo = zeroed
    return lambda: setattr(sharding.FrameShard, "halo", halo)


def _ungathered_bank(sharding):
    """The fault: the play's bank is not gathered; a picked frame of another
    process reads as zeros."""
    gather_bank = sharding.FrameShard.gather_bank

    def local_only(self, x):
        whole = x.new_zeros(x.shape[0], self.total, *x.shape[2:])
        whole[:, self.offset: self.offset + self.count] = x
        return whole

    sharding.FrameShard.gather_bank = local_only
    return lambda: setattr(sharding.FrameShard, "gather_bank", gather_bank)


def _seq_child(rank: int, world: int, spec: tuple, video, small_left, small_right):
    """One process of the seq phase on a (data, seq, space) = `spec` mesh of
    all processes: the main path's predictor (when `video` is given; counted,
    timed, the bytes received over seq counted), then the small clip's f32
    forward, sound and (with the main path) with each planted fault."""
    from datetime import timedelta

    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from functools import partial

    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig, PPMUpdateLoop
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.parallel import collectives, sharding
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    torch.cuda.set_device(0)
    mesh = make_mesh(MeshSpec(*spec), timeout=timedelta(seconds=SEQ_TIMEOUT_S))
    flat = load_npz(ANCHOR)
    out = dict(staged=collectives.host_staged(mesh.groups["seq"], torch.device("cuda")))
    if video is not None:
        pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=flat,
                         mesh=mesh)
        window_s: list = []
        _timed_windows(pred, window_s)
        torch.cuda.reset_peak_memory_stats()
        pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
        sharding.RECEIVED.update(dict.fromkeys(sharding.RECEIVED, 0))
        t0 = time.perf_counter()
        disp = pred({"stereo_video": video})["disparity"]
        out.update(disparity=disp, seconds=time.perf_counter() - t0, window_s=window_s,
                   play=pa.play_attention.launches, lookup=kl.corr_lookup_kernel.launches,
                   received=dict(sharding.RECEIVED),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del pred
        torch.cuda.empty_cache()
    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=SEQ_SMALL_ITERS,
                      test_mode=True, mesh=mesh)
    load_flax_params(model, flat)
    model.cuda().eval()
    small = {}
    faults = {"zero_halos": _zero_halos, "ungathered_bank": _ungathered_bank}
    runs = ("sound", *SEQ_FAULTS) if video is not None else ("sound", "space_only")
    for run in runs:
        undo = faults[run](sharding) if run in faults else None
        if run == "space_only":  # the same space groups, the seq axis left out
            model.seq_group = None
        if run == "sound" and video is None:  # each ringed play held as in phase ring
            out["plays"] = []
            undo = partial(setattr, PPMUpdateLoop, "_play", _checked_plays(out["plays"]))
        pa.play_attention_carry.launches = 0
        try:
            with torch.no_grad():
                disp, _ = model(torch.from_numpy(small_left).cuda(),
                                torch.from_numpy(small_right).cuda())
        finally:
            if undo is not None:
                undo()
        small[run] = disp.cpu().numpy()
        if run == "sound":
            out["small_carry"] = pa.play_attention_carry.launches
    out["small"] = small
    return out


def phase_seq(main_run: dict, small_run: dict, smi: str):
    """The mesh's seq axis in SEQ_RANKS processes sharing the card: the main
    path's clip (its windows' frames spread over the processes) against the
    single-process main run at the strict modes' limits, kernels 1 and 6
    launched LAUNCHES_PER_WINDOW times a window and rank, seconds per window
    and bytes received per window and rank; the small clip in f32 under seq
    2 against the card's single-process output at the ring's limit, which
    both planted faults must exceed, and under seq x space 2 x 2 each ringed
    play step against the unsharded play on its inputs."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
    from ppmstereo_tpu_torch.parallel.launch import run_group
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    t_phase = time.perf_counter()
    left = np.ascontiguousarray(small_run["left"][:, :SEQ_SMALL_FRAMES])
    right = np.ascontiguousarray(small_run["right"][:, :SEQ_SMALL_FRAMES])
    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=SEQ_SMALL_ITERS,
                      test_mode=True)
    load_flax_params(model, load_npz(ANCHOR))
    model.cuda().eval()
    with torch.no_grad():
        small_ref = model(torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda())[0]
    small_ref = small_ref.cpu().numpy()
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_group(_seq_child, SEQ_RANKS, ((1, SEQ_RANKS, 1), main_run["video"], left,
                                                 right), timeout_s=SEQ_TIMEOUT_S, threads=4)
    seq_wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spaced = run_group(_seq_child, 2 * SEQ_RANKS, ((1, SEQ_RANKS, 2), None, left, right),
                       timeout_s=SEQ_TIMEOUT_S, threads=2)
    space_wall_s = time.perf_counter() - t0
    ref, gt = main_run["disparity"], main_run["gt"]
    n_windows = len(main_run["window_s"])
    want = LAUNCHES_PER_WINDOW * n_windows
    # the clip's windows whose frames spread: the tail of CLIP_FRAMES - (its
    # start) frames runs whole where the axis does not divide it
    starts = range(0, CLIP_FRAMES, WINDOW // 2)
    lengths = [min(WINDOW, CLIP_FRAMES - s) for s in starts]
    lengths = [n for i, n in enumerate(lengths) if i == 0 or n >= WINDOW // 2]
    sharded = sum(1 for n in lengths if n % SEQ_RANKS == 0)
    small_plays = 2 * (SEQ_SMALL_ITERS // 2) + SEQ_SMALL_ITERS
    want_carry = 2 * small_plays  # 2 hops a play
    readings = []
    for rank, res in enumerate(results):
        disp = res["disparity"]
        diff = np.abs(disp - ref)
        epe = float(np.abs(disp[..., 0] - gt).mean())
        small = {run: float(np.abs(d - small_ref).max()) for run, d in res["small"].items()}
        received = {k: v / sharded for k, v in res["received"].items()}
        r = dict(rank=rank, window_s=res["window_s"], seconds=res["seconds"],
                 play=res["play"], lookup=res["lookup"], peak_gb=res["peak_gb"],
                 mean_abs_diff=float(diff.mean()), max_abs_diff=float(diff.max()), epe=epe,
                 epe_diff=abs(epe - main_run["epe"]), received_per_window=received,
                 small=small)
        readings.append(r)
        log(f"seq rank {rank} of {SEQ_RANKS} on one card ({smi}), "
            f"{'gloo, host-staged' if res['staged'] else 'device'}: windows "
            f"{[round(x, 3) for x in res['window_s']]} s ({sharded} of {len(lengths)} "
            f"sharded), {res['seconds']:.2f} s in the predictor, peak {res['peak_gb']:.2f} GB; "
            f"launches kernel 1 {res['play']} and kernel 6 {res['lookup']} (expected {want} "
            f"each); received per sharded window: bank "
            f"{received['bank'] / 1e6:.1f} MB, halos {received['halo'] / 1e6:.1f} MB, other "
            f"frames {received['frames'] / 1e6:.1f} MB; against the single process: mean "
            f"|diff| {r['mean_abs_diff']:.3e} px (tol {STRICT_MEAN_TOL}), max "
            f"{r['max_abs_diff']:.3e} px, EPE {epe:.4f} px (single process "
            f"{main_run['epe']:.4f}; tol {STRICT_EPE_TOL}); f32 small clip (1, "
            f"{SEQ_SMALL_FRAMES}, 64, 128): max |disparity - single process| "
            f"{small['sound']:.3e} px (tol {RING_SMALL_TOL}), halos zeroed "
            f"{small['zero_halos']:.3e} px, bank ungathered {small['ungathered_bank']:.3e} px")
    space_readings = []
    for rank, res in enumerate(spaced):
        sound, ring = res["small"]["sound"], res["small"]["space_only"]
        plays = _play_shares(res["plays"], max)
        space_readings.append(dict(rank=rank, plays=plays, carry=res["small_carry"],
                                   ring_max_abs_diff=float(np.abs(sound - ring).max()),
                                   single_max_abs_diff=float(np.abs(sound - small_ref).max()),
                                   ring_single_max_abs_diff=float(np.abs(ring - small_ref).max())))
        log(f"seq x space 2 x 2 rank {rank}, f32 small clip: {plays['calls']} ringed play steps "
            f"(expected {small_plays}) against the unsharded play on the same inputs, at worst "
            f"max_abs_err {plays['max_abs_err']:.3e} and mean_abs_err "
            f"{plays['mean_abs_err']:.3e}, {plays['max_share']:.3f} and "
            f"{plays['mean_share']:.3f} of their limits; kernel 5 launched "
            f"{res['small_carry']} times (expected {want_carry}); max |disparity| against the "
            f"single process {space_readings[-1]['single_max_abs_diff']:.3e} px, against the "
            f"space-2 ring {space_readings[-1]['ring_max_abs_diff']:.3e} px (the space-2 ring "
            f"against the single process {space_readings[-1]['ring_single_max_abs_diff']:.3e} "
            f"px)")
    log(f"seq phase: {time.perf_counter() - t_phase:.1f} s ({seq_wall_s:.1f} s for the seq "
        f"group, {space_wall_s:.1f} s for the seq x space group, with process start); "
        f"processes sharing one card: time-sharing, not a scaling result")
    for r, res in zip(readings, results):
        disp = res["disparity"]
        if disp.shape != ref.shape or not np.isfinite(disp).all():
            raise RuntimeError(f"seq rank {r['rank']}: disparity of shape {disp.shape} "
                               f"(want {ref.shape}) or non-finite")
        if not res["staged"]:
            raise RuntimeError("the seq phase expects a gloo group staged through the host")
        if r["play"] != want or r["lookup"] != want:
            raise RuntimeError(f"seq rank {r['rank']}: kernel 1 / 6 launches {r['play']} / "
                               f"{r['lookup']}, expected {want}")
        if not (r["mean_abs_diff"] <= STRICT_MEAN_TOL and r["epe_diff"] <= STRICT_EPE_TOL):
            raise RuntimeError(f"seq rank {r['rank']}: the windows differ from the single "
                               f"process's: mean {r['mean_abs_diff']:.3e} px, EPE "
                               f"{r['epe_diff']:.3e} px")
        if not r["small"]["sound"] <= RING_SMALL_TOL:
            raise RuntimeError(f"seq rank {r['rank']}: the f32 small clip differs from the "
                               f"single process by {r['small']['sound']:.3e} px")
        for fault in SEQ_FAULTS:
            if not r["small"][fault] > RING_SMALL_TOL:
                raise RuntimeError(f"the seq limit does not catch the fault {fault}: "
                                   f"{r['small'][fault]:.3e} px")
    for s in space_readings:
        plays = s["plays"]
        if s["carry"] != want_carry or plays["calls"] != small_plays or not (
                plays["max_share"] <= 1 and plays["mean_share"] <= 1):
            raise RuntimeError(f"seq x space rank {s['rank']}: {s}, expected {small_plays} "
                               f"ringed plays within kernel 1's limits and {want_carry} "
                               "kernel 5 launches")
    return dict(readings=readings, space=space_readings, seq_wall_s=seq_wall_s,
                space_wall_s=space_wall_s, play_launches=readings[0]["play"],
                lookup_launches=readings[0]["lookup"], carry_launches=space_readings[0]["carry"])


# the data phase: the mesh's data axis over DATA_RANKS processes sharing the
# card (gloo, staged through pinned host buffers), as the ring phase runs:
# DATA_TRAIN_STEPS train steps at TrainConfig() with batch 2 (one clip a
# rank) on one fixed batch, the main path's clip through model_zoo with
# batch_windows=2 (each rank runs one window of a pair), and
# evaluate_distributed on DATA_EVAL_FRAMES-frame sequences; each against the
# same work in one process (this one)
DATA_RANKS = 2
DATA_TIMEOUT_S = 600
DATA_TRAIN_STEPS = 3
DATA_DIR = REPO / "build" / "chip_smoke_data"
DATA_EVAL_FRAMES = (10, 7, 4)  # three sequences of unequal length, seeds 1-3
# per rank: the batch's first pair splits over the ranks, the third and the
# tail window run whole on each (window_frames: 10, 10, 10, 5)
DATA_WINDOWS_PER_RANK = 3
DATA_EVAL_TOL = 1e-6  # relative: the same windows in other processes
# The train path is held twice. The f32 small step (the train small
# parity's anchor, 2 iterations, 3 frames at 64x128, here a batch of 2:
# one clip a rank) against this process's f32 step on the card, at the
# train phase's limits (TRAIN_*: loss, tensor and one-element gradients,
# updated elements). TrainConfig() in bf16 cannot be held there: one clip a
# call is not two to the libraries (other algorithms, other last bits), and
# in bf16 that grows through 30 iterations. On an H100 (NVIDIA H100 80GB
# HBM3, 700.00 W) the 2-rank bf16 losses read 1.25e-4 / 3.10e-4 / 2.31e-3
# of one process's at steps 1-3 and the gradients after step 1 parted
# by a norm ratio of 0.84 (a first convolution's bias, whose true gradient
# is ~0) and 0.15 (the 1/16 play blend). So at TrainConfig() the losses are
# held to DATA_BF16_LOSS_TOL (4x the largest reading: a loss that is not
# the global batch's, a rank's share or its own mean, is off by 10-50 %)
# and the gradients are printed; the ranks' parameters must stay bit-equal.
DATA_BF16_LOSS_TOL = 1e-2
DATA_SMALL = (2, 3, 64, 128)  # clips, frames, height, width of the f32 step


def _digest(tensors) -> str:
    """A hash of the tensors' bytes (bit-equality across processes)."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextmanager
def _recorded_training(record: dict, trace_last: bool = False):
    """Patch the trainer for one `train()` run: each train step timed under
    torch.cuda.synchronize() with its kernel launches and the bytes received
    over a seq axis in its forward and in its backward (`sharding.RECEIVED`:
    the recomputed iterations' messages and the cotangents' count in the
    backward), the trainable parameters hashed after it, the gradient
    all-reduce timed with its bytes, and the gradients the optimiser reads
    at the first step kept (`record["grads"]`, by parameter name, on the
    CPU). With `trace_last`, step DATA_TRAIN_STEPS runs under torch.profiler
    with the device traced alone (`record["traced"]`, `_train_kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppmstereo_tpu_torch.parallel import sharding
    from ppmstereo_tpu_torch.train import step as step_module
    from ppmstereo_tpu_torch.train import trainer
    from ppmstereo_tpu_torch.train.state import TrainOptimizer

    record.update(step_s=[], launches=[], digests=[], allreduce_s=[], allreduce_bytes=[],
                  received=[])
    train_step, reduce, opt_step = (trainer.train_step, step_module.all_reduce_gradients,
                                    TrainOptimizer.step)
    predict = step_module.predictions
    forward_end: list = []

    def counted_predictions(*args):
        out = predict(*args)
        forward_end.append(dict(sharding.RECEIVED))
        return out
    build = trainer.build_train_model
    names = {}

    def built(*args, **kwargs):
        model, has_unc = build(*args, **kwargs)
        names.update({id(p): n for n, p in model.named_parameters()})
        return model, has_unc

    def timed_step(state, batch):
        torch.cuda.synchronize()
        before, t0 = _launch_counts(), time.perf_counter()
        start = dict(sharding.RECEIVED)
        if trace_last and len(record["step_s"]) == DATA_TRAIN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = train_step(state, batch)
                torch.cuda.synchronize()
            record["traced"] = _train_kernels(prof)
        else:
            out = train_step(state, batch)
        torch.cuda.synchronize()
        record["step_s"].append(time.perf_counter() - t0)
        after = _launch_counts()
        record["launches"].append({k: after[k] - before[k] for k in after})
        mid, end = forward_end.pop(), dict(sharding.RECEIVED)
        record["received"].append({"forward": {k: mid[k] - start[k] for k in start},
                                   "backward": {k: end[k] - mid[k] for k in start}})
        record["digests"].append(_digest(p for g in state.optimizer.groups for p in g))
        return out

    def timed_reduce(state):
        torch.cuda.synchronize()
        n, t0 = step_module.REDUCED["bytes"], time.perf_counter()
        reduce(state)
        torch.cuda.synchronize()
        record["allreduce_s"].append(time.perf_counter() - t0)
        record["allreduce_bytes"].append(step_module.REDUCED["bytes"] - n)

    def first_grads(self):
        if "grads" not in record:
            record["grads"] = {names[id(p)]: p.grad.detach().float().cpu().clone()
                               for g in self.groups for p in g if p.grad is not None}
        return opt_step(self)

    trainer.build_train_model, trainer.train_step = built, timed_step
    step_module.all_reduce_gradients, TrainOptimizer.step = timed_reduce, first_grads
    step_module.predictions = counted_predictions
    try:
        yield
    finally:
        trainer.build_train_model, trainer.train_step = build, train_step
        step_module.all_reduce_gradients, TrainOptimizer.step = reduce, opt_step
        step_module.predictions = predict


def _data_train(out_dir: Path, batch: dict, trace_last: bool = False, **cfg_kwargs) -> dict:
    """train() at TrainConfig(**cfg_kwargs) from the anchor, DATA_TRAIN_STEPS
    steps on the global `batch` (each rank takes its part in a group), the
    last one traced with `trace_last`; returns the recorded steps
    (`_recorded_training`) and the losses of the run's metrics log (rank
    0's, None on the other ranks). `out_dir` must not exist yet: the caller
    clears it, and deletes it after the run (every rank of a group uses
    it)."""
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, train
    from ppmstereo_tpu_torch.utils.weights import load_npz

    cfg = TrainConfig(exp_dir=str(out_dir), log_freq=1, **cfg_kwargs)
    record: dict = {}
    with _recorded_training(record, trace_last):
        train(cfg, loader=[batch] * DATA_TRAIN_STEPS, max_steps=DATA_TRAIN_STEPS,
              init_params=load_npz(ANCHOR), device="cuda")
    log_path = out_dir / "metrics.jsonl"
    record["losses"] = ([json.loads(x)["loss"] for x in log_path.read_text().splitlines()]
                        if log_path.is_file() else None)
    return record


def _eval_sequences() -> list:
    """Synthetic sequences at the main path's size, with ground truth."""
    import numpy as np

    out = []
    for seed, frames in enumerate(DATA_EVAL_FRAMES, start=1):
        video, gt = synthetic_clip(frames, HEIGHT, WIDTH, seed=seed)
        out.append({"img": video, "disp": -gt[:, None, :, :, None],
                    "valid": np.ones((frames, 1, HEIGHT, WIDTH), np.float32)})
    return out


def _small_batch() -> dict:
    """DATA_SMALL's batch: the synthetic dataset's clips of seeds 0, 1, ..."""
    import numpy as np

    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset

    n, frames, h, w = DATA_SMALL
    samples = [SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w,
                                      seed=seed)[0] for seed in range(n)]
    return {"left": np.stack([s["img"][:, 0] for s in samples]),
            "right": np.stack([s["img"][:, 1] for s in samples]),
            "disparity": np.stack([s["disp"][:, 0] for s in samples]),
            "valid": np.stack([s["valid"][:, 0] for s in samples])}


def _small_step_against(ref_path: str, mesh, batch: dict) -> dict:
    """The f32 small step over the mesh (`batch`: this rank's part of the
    batch) against the one-process step saved at `ref_path`."""
    import torch

    from ppmstereo_tpu_torch.train.state import onecycle_lr
    from ppmstereo_tpu_torch.utils.weights import load_npz

    loss, grads, params, opt = _one_train_step("cuda", load_npz(ANCHOR), batch, mesh=mesh)
    ref = torch.load(ref_path, weights_only=True)
    lr0 = onecycle_lr(0, opt.num_steps, opt.lr)
    n_off = sum(int(((params[n] - p).abs() > lr0 / 2).sum()) for n, p in ref["params"].items())
    return dict(loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                grad=grad_agreement(grads, ref["grads"]),
                update_off=n_off / sum(p.numel() for p in ref["params"].values()))


def _data_child(rank: int, world: int, batch: dict, video, sequences, ref_grads_path: str,
                small_ref_path: str):
    """One process of the data phase: the train steps (their gradients after
    step 1 read against the one-process run's here), the f32 small step,
    the clip through model_zoo(batch_windows=2, mesh), and
    evaluate_distributed."""
    from datetime import timedelta

    import torch

    from ppmstereo_tpu_torch.evaluation.distributed import evaluate_distributed
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.parallel.collectives import host_staged
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.parallel.sharding import local_batch
    from ppmstereo_tpu_torch.utils.weights import load_npz

    torch.cuda.set_device(0)
    for fn in (pa.play_attention, pa.play_attention_fwd_res, pa.play_attention_bwd_dq,
               pa.play_attention_bwd_dkv, kl.corr_lookup_kernel):
        fn.launches = 0
    train_run = _data_train(DATA_DIR / "dp", batch)
    want = torch.load(ref_grads_path, weights_only=True)
    got = train_run.pop("grads")
    train_run["grad"] = grad_agreement(got, want)
    train_run["grad_names"] = sorted(got) == sorted(want)
    del got, want

    mesh = make_mesh(MeshSpec(data=world), timeout=timedelta(seconds=DATA_TIMEOUT_S))
    small = _small_step_against(small_ref_path, mesh, local_batch(_small_batch(), rank, world))
    params = load_npz(ANCHOR)
    pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=params,
                     batch_windows=2, mesh=mesh)
    pred({"stereo_video": video})  # warm
    window_s: list = []
    window_fn = _timed_windows(pred, window_s)
    pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    disp = pred({"stereo_video": video})["disparity"]
    seconds = time.perf_counter() - t0
    pred.predictor.window_fn = window_fn
    windows = dict(disparity=disp, window_s=window_s, seconds=seconds,
                   play=pa.play_attention.launches, lookup=kl.corr_lookup_kernel.launches,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del pred

    plain = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=params)
    t0 = time.perf_counter()
    metrics = evaluate_distributed(None, plain, sequences)
    return dict(train=train_run, small=small, windows=windows, eval=metrics,
                eval_s=time.perf_counter() - t0,
                staged=host_staged(mesh.groups["data"], torch.device("cuda")))


def phase_data(smi: str) -> dict:
    """The mesh's data axis over DATA_RANKS processes on the one card (gloo,
    host-staged): train steps, windows and evaluation, each against the same
    work in this process. Every failure raises."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader
    from ppmstereo_tpu_torch.evaluation.evaluator import Evaluator
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.parallel.launch import run_group
    from ppmstereo_tpu_torch.train.trainer import TrainConfig
    from ppmstereo_tpu_torch.utils.weights import load_npz

    t_phase = time.perf_counter()
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    cfg = TrainConfig()
    batch = next(iter(fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                       batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                       seed=cfg.seed)))
    one = _data_train(DATA_DIR / "one", batch)
    shutil.rmtree(DATA_DIR / "one" / "ckpt")  # ~780 MB
    ref_grads = DATA_DIR / "ref_grads.pt"
    torch.save(one.pop("grads"), ref_grads)
    small_loss, small_grads, small_params, _ = _one_train_step("cuda", load_npz(ANCHOR),
                                                               _small_batch())
    small_ref = DATA_DIR / "small_ref.pt"
    torch.save({"loss": small_loss, "grads": small_grads, "params": small_params}, small_ref)
    del small_grads, small_params
    video, gt = synthetic_clip(CLIP_FRAMES, HEIGHT, WIDTH, seed=0)
    params = load_npz(ANCHOR)
    pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=params,
                     batch_windows=2)
    ref = pred({"stereo_video": video})["disparity"]
    sequences = _eval_sequences()
    plain = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=params)
    want_eval = Evaluator().evaluate_sequence(plain, sequences)["aggregate"]
    del pred, plain
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    results = run_group(_data_child, DATA_RANKS, (batch, video, sequences, str(ref_grads),
                                                   str(small_ref)),
                        timeout_s=DATA_TIMEOUT_S, threads=4)
    wall_s = time.perf_counter() - t0
    ref_epe = float(np.abs(ref[..., 0] - gt).mean())
    losses = [json.loads(x)["loss"]
              for x in (DATA_DIR / "dp" / "metrics.jsonl").read_text().splitlines()]
    shutil.rmtree(DATA_DIR, ignore_errors=True)  # rank 0's checkpoint: ~780 MB
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
    log(f"data phase: {DATA_RANKS} processes sharing one card ({smi}) over gloo, "
        f"{'host-staged' if results[0]['staged'] else 'device'}; these times are time-sharing, "
        f"not a scaling result. One process: train steps "
        f"{[round(x, 3) for x in one['step_s']]} s, losses {one['losses']}")
    log(f"data train, TrainConfig() at batch {cfg.batch_size} ({cfg.batch_size // DATA_RANKS} "
        f"clip a rank), {DATA_TRAIN_STEPS} steps on one batch: global losses {losses}, against "
        f"one process {[f'{x:.2e}' for x in loss_rel]} relative (tol {DATA_BF16_LOSS_TOL})")
    readings = []
    for rank, res in enumerate(results):
        tr, win = res["train"], res["windows"]
        grad = tr["grad"]
        diff = np.abs(win["disparity"] - ref)
        epe = float(np.abs(win["disparity"][..., 0] - gt).mean())
        eval_rel = {k: abs(res["eval"][k] - v) / max(abs(v), 1e-12) for k, v in want_eval.items()
                    if k not in ("fps", "num_sequences")}
        r = dict(rank=rank, step_s=tr["step_s"], launches=tr["launches"],
                 allreduce_s=tr["allreduce_s"], allreduce_bytes=tr["allreduce_bytes"],
                 grad=grad, small=res["small"], window_s=win["window_s"],
                 windows_s=win["seconds"],
                 play=win["play"], lookup=win["lookup"], peak_gb=win["peak_gb"],
                 mean_abs_diff=float(diff.mean()), max_abs_diff=float(diff.max()), epe=epe,
                 epe_diff=abs(epe - ref_epe), eval_worst=max(eval_rel.values()),
                 eval_s=res["eval_s"], total_frames=res["eval"].get("total_frames"))
        readings.append(r)
        log(f"data rank {rank}: train seconds per step {[round(x, 3) for x in tr['step_s']]}; "
            f"gradient all-reduce per step {[round(x, 4) for x in tr['allreduce_s']]} s for "
            f"{tr['allreduce_bytes'][0] / 1e6:.1f} MB; launches per step {tr['launches'][0]} "
            f"(expected {TRAIN_LAUNCHES_PER_STEP}); bf16 gradients after step 1 against one "
            f"process (read, not held): tensors {grad['tensor'][0]:.3e} ({grad['tensor'][1]}), "
            f"one-element {grad['scalar'][0]:.3e} ({grad['scalar'][1]})")
        sm = res["small"]
        log(f"data rank {rank}: f32 step {DATA_SMALL} against one process on the card: loss "
            f"{sm['loss_rel']:.2e} relative (tol {TRAIN_LOSS_TOL}); gradients: tensors "
            f"{sm['grad']['tensor'][0]:.3e} ({sm['grad']['tensor'][1]}; tol {TRAIN_GRAD_TOL}), "
            f"one-element {sm['grad']['scalar'][0]:.3e} ({sm['grad']['scalar'][1]}; tol "
            f"{TRAIN_SCALAR_GRAD_TOL}); {sm['update_off']:.2e} of the updated elements off by "
            f"more than lr/2 (tol {TRAIN_UPDATE_TOL})")
        log(f"data rank {rank}: windows (batch_windows=2) {[round(x, 3) for x in win['window_s']]}"
            f" s, {win['seconds']:.3f} s for the clip, kernel 1 launches {win['play']} and "
            f"kernel 6 {win['lookup']} (expected {DATA_WINDOWS_PER_RANK * LAUNCHES_PER_WINDOW} "
            f"each), peak {win['peak_gb']:.2f} GB; against one process: mean |diff| "
            f"{r['mean_abs_diff']:.3e} px (tol {STRICT_MEAN_TOL}), max {r['max_abs_diff']:.3e} px, "
            f"EPE {epe:.4f} px (one process {ref_epe:.4f}; tol {STRICT_EPE_TOL}); "
            f"evaluate_distributed over {DATA_EVAL_FRAMES} frames in {res['eval_s']:.2f} s: "
            f"metrics against one process's evaluator at worst {r['eval_worst']:.2e} relative "
            f"(tol {DATA_EVAL_TOL})")
    log(f"data phase: {time.perf_counter() - t_phase:.1f} s ({t_ref:.1f} s of one-process "
        f"references, {wall_s:.1f} s for the group with process start)")

    if not all(res["staged"] for res in results):
        raise RuntimeError("the data phase expects a gloo group staged through the host")
    if len(losses) != DATA_TRAIN_STEPS or not all(r <= DATA_BF16_LOSS_TOL for r in loss_rel):
        raise RuntimeError(f"data-parallel losses {losses} against one process's "
                           f"{one['losses']}")
    for r, res in zip(readings, results):
        tr = res["train"]
        if tr["digests"] != results[0]["train"]["digests"]:
            raise RuntimeError(f"data rank {r['rank']}: parameters differ from rank 0's")
        if any(step != TRAIN_LAUNCHES_PER_STEP for step in r["launches"]):
            raise RuntimeError(f"data rank {r['rank']}: launches per step {r['launches']}")
        sm = res["small"]
        if not (tr["grad_names"] and sm["loss_rel"] <= TRAIN_LOSS_TOL
                and sm["grad"]["tensor"][0] <= TRAIN_GRAD_TOL
                and sm["grad"]["scalar"][0] <= TRAIN_SCALAR_GRAD_TOL
                and sm["update_off"] <= TRAIN_UPDATE_TOL):
            raise RuntimeError(f"data rank {r['rank']}: the f32 step against one process {sm}")
        want_launches = DATA_WINDOWS_PER_RANK * LAUNCHES_PER_WINDOW
        if r["play"] != want_launches or r["lookup"] != want_launches:
            raise RuntimeError(f"data rank {r['rank']}: kernel 1 / 6 launches {r['play']} / "
                               f"{r['lookup']}, expected {want_launches}")
        if not (r["mean_abs_diff"] <= STRICT_MEAN_TOL and r["epe_diff"] <= STRICT_EPE_TOL):
            raise RuntimeError(f"data rank {r['rank']}: windows differ from one process's")
        if not r["eval_worst"] <= DATA_EVAL_TOL:
            raise RuntimeError(f"data rank {r['rank']}: evaluate_distributed {res['eval']} "
                               f"against {want_eval}")
    return dict(readings=readings, one=one, losses=losses, loss_rel=loss_rel, wall_s=wall_s,
                launches={k: sum(step[k] for step in readings[0]["launches"])
                          for k in readings[0]["launches"][0]},
                play_launches=readings[0]["play"], lookup_launches=readings[0]["lookup"])


# the seq phase in training: the mesh's seq axis over SEQ_TRAIN_RANKS
# processes sharing the card (gloo, staged through pinned host buffers):
# DATA_TRAIN_STEPS train steps at TrainConfig() with SEQ_TRAIN_FRAMES-frame
# clips (the shipped 5 does not divide over 2: the trainer refuses it, as
# the JAX package's placement of the batch does), each rank 3 frames of both
# clips, on one fixed batch, the last step profiled; an f32 step of a small
# clip; each against the same work in this process. The bf16 losses
# are held at the data phase's DATA_BF16_LOSS_TOL (bf16 steps are not
# batch-invariant: a call of 3 frames is not one of 6 to the libraries),
# the f32 step at tests/torch_train_parity.py's limits: the loss within
# SEQ_TRAIN_LOSS_TOL relative, every significant gradient (one-element
# tensors too) within TRAIN_GRAD_TOL, at most TRAIN_UPDATE_TOL of the
# updated elements off by more than lr / 2; the ranks' parameters must stay
# bit-equal after every step
SEQ_TRAIN_RANKS = 2
SEQ_TRAIN_FRAMES = 6
SEQ_TRAIN_DIR = REPO / "build" / "chip_smoke_seq_train"
SEQ_TRAIN_SMALL = (1, 4, 64, 128)  # clips, frames, height, width of the f32 step
SEQ_TRAIN_LOSS_TOL = 1e-5
# the train kernels as the profiler names them (kernel 2 is the forward
# template's WITH_LSE instance)
SEQ_TRAIN_TRACE = {"play_attention_fwd_res": "play_attention_fwd_kernel<1>",
                   "play_attention_bwd_dq": "play_attention_bwd_dq_kernel",
                   "play_attention_bwd_dkv": "play_attention_bwd_dkv_kernel"}


def _seq_small_batch() -> dict:
    """SEQ_TRAIN_SMALL's batch: the synthetic dataset's clip of seed 0."""
    import numpy as np

    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset

    _, frames, h, w = SEQ_TRAIN_SMALL
    s = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w, seed=0)[0]
    return {"left": s["img"][None, :, 0], "right": s["img"][None, :, 1],
            "disparity": s["disp"][None, :, 0], "valid": s["valid"][None, :, 0].astype(np.float32)}


def _train_kernels(prof) -> dict:
    """The train kernels' launches and device ms in a profiler's trace,
    counted by SEQ_TRAIN_TRACE's names, and the trace's device ms."""
    import torch

    averages = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"device_ms": sum(e.self_device_time_total for e in averages) / 1e3}
    for name, fragment in SEQ_TRAIN_TRACE.items():
        hits = [e for e in averages if fragment in e.key]
        out[name] = dict(launches=sum(e.count for e in hits),
                         ms=sum(e.self_device_time_total for e in hits) / 1e3)
    return out


def _seq_train_child(rank: int, world: int, batch: dict, ref_grads_path: str,
                     small_ref_path: str):
    """One process of the seq-training phase: the train steps over seq (this
    rank's frames of the fixed batch, the last one traced; its gradients
    after step 1 read against the one-process run's) and the f32 small step
    over seq."""
    from datetime import timedelta

    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.parallel.collectives import host_staged
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.parallel.sharding import local_frames

    torch.cuda.set_device(0)
    for fn in (pa.play_attention, pa.play_attention_fwd_res, pa.play_attention_bwd_dq,
               pa.play_attention_bwd_dkv, kl.corr_lookup_kernel):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    run = _data_train(SEQ_TRAIN_DIR / "seq", batch, trace_last=True,
                      sample_len=SEQ_TRAIN_FRAMES, seq_parallel=world)
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    want = torch.load(ref_grads_path, weights_only=True)
    got = run.pop("grads")
    run["grad"] = grad_agreement(got, want)
    run["grad_names"] = sorted(got) == sorted(want)
    del got, want
    torch.cuda.empty_cache()
    mesh = make_mesh(MeshSpec(seq=world), timeout=timedelta(seconds=SEQ_TIMEOUT_S))
    small = _small_step_against(small_ref_path, mesh,
                                local_frames(_seq_small_batch(), rank, world))
    return dict(train=run, small=small,
                staged=host_staged(mesh.groups["seq"], torch.device("cuda")))


def phase_seq_train(smi: str) -> dict:
    """The mesh's seq axis in training over SEQ_TRAIN_RANKS processes on the
    one card (gloo, host-staged): train steps at TrainConfig() with
    SEQ_TRAIN_FRAMES-frame clips and an f32 small step, each against the
    same work in this process. Every failure raises."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader
    from ppmstereo_tpu_torch.parallel.launch import run_group
    from ppmstereo_tpu_torch.train.trainer import TrainConfig
    from ppmstereo_tpu_torch.utils.weights import load_npz

    t_phase = time.perf_counter()
    shutil.rmtree(SEQ_TRAIN_DIR, ignore_errors=True)
    cfg = TrainConfig(sample_len=SEQ_TRAIN_FRAMES)
    batch = next(iter(fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                       batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                       seed=cfg.seed)))
    torch.cuda.reset_peak_memory_stats()
    one = _data_train(SEQ_TRAIN_DIR / "one", batch, sample_len=SEQ_TRAIN_FRAMES)
    one_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(SEQ_TRAIN_DIR / "one" / "ckpt")  # ~780 MB
    ref_grads = SEQ_TRAIN_DIR / "ref_grads.pt"
    torch.save(one.pop("grads"), ref_grads)
    small_loss, small_grads, small_params, _ = _one_train_step("cuda", load_npz(ANCHOR),
                                                               _seq_small_batch())
    small_ref = SEQ_TRAIN_DIR / "small_ref.pt"
    torch.save({"loss": small_loss, "grads": small_grads, "params": small_params}, small_ref)
    del small_grads, small_params
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    results = run_group(_seq_train_child, SEQ_TRAIN_RANKS,
                        (batch, str(ref_grads), str(small_ref)), timeout_s=SEQ_TIMEOUT_S,
                        threads=4)
    wall_s = time.perf_counter() - t0
    losses = [json.loads(x)["loss"]
              for x in (SEQ_TRAIN_DIR / "seq" / "metrics.jsonl").read_text().splitlines()]
    shutil.rmtree(SEQ_TRAIN_DIR, ignore_errors=True)  # rank 0's checkpoint: ~780 MB
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
    log(f"seq train phase: {SEQ_TRAIN_RANKS} processes sharing one card ({smi}) over gloo, "
        f"{'host-staged' if results[0]['staged'] else 'device'}; time-sharing, not a scaling "
        f"result. One process, TrainConfig(sample_len={SEQ_TRAIN_FRAMES}): steps "
        f"{[round(x, 3) for x in one['step_s']]} s, peak {one_peak_gb:.2f} GB, losses "
        f"{one['losses']}")
    log(f"seq train, batch {cfg.batch_size} of {SEQ_TRAIN_FRAMES} frames "
        f"({SEQ_TRAIN_FRAMES // SEQ_TRAIN_RANKS} a rank), {DATA_TRAIN_STEPS} steps on one "
        f"batch: global losses {losses}, against one process "
        f"{[f'{x:.2e}' for x in loss_rel]} relative (tol {DATA_BF16_LOSS_TOL})")
    readings = []
    for rank, res in enumerate(results):
        tr, sm = res["train"], res["small"]
        received = [{phase: {k: v / 1e6 for k, v in step[phase].items()} for phase in step}
                    for step in tr["received"]]
        r = dict(rank=rank, step_s=tr["step_s"], launches=tr["launches"],
                 allreduce_s=tr["allreduce_s"], allreduce_bytes=tr["allreduce_bytes"],
                 received_mb=received, peak_gb=tr["peak_gb"], grad=tr["grad"],
                 traced=tr["traced"], small=sm)
        readings.append(r)
        fwd, bwd = received[0]["forward"], received[0]["backward"]
        traced = tr["traced"]
        log(f"seq train rank {rank}: seconds per step {[round(x, 3) for x in tr['step_s']]} "
            f"(step {DATA_TRAIN_STEPS} under the profiler); "
            f"peak {tr['peak_gb']:.2f} GB; gradient all-reduce per step "
            f"{[round(x, 4) for x in tr['allreduce_s']]} s for "
            f"{tr['allreduce_bytes'][0] / 1e6:.1f} MB; launches per step {tr['launches'][0]} "
            f"(expected {TRAIN_LAUNCHES_PER_STEP})")
        log(f"seq train rank {rank}: received in step 1, forward: bank {fwd['bank']:.1f}, "
            f"halos {fwd['halo']:.1f}, other frames {fwd['frames']:.1f} MB; backward: the "
            f"recomputed iterations' bank {bwd['bank']:.1f}, halos {bwd['halo']:.1f}, other "
            f"{bwd['frames']:.1f} MB, the cotangents' bank {bwd['bank_grad']:.1f}, halos "
            f"{bwd['halo_grad']:.1f}, other {bwd['frames_grad']:.1f} MB; total "
            f"{sum(fwd.values()) + sum(bwd.values()):.1f} MB")
        log(f"seq train rank {rank}: step {DATA_TRAIN_STEPS} traced (the device alone): "
            f"{traced['device_ms']:.1f} ms of device time; kernels 2 / 3 / 4 in the trace "
            + ", ".join(f"{traced[k]['launches']} launches {traced[k]['ms']:.2f} ms"
                        for k in SEQ_TRAIN_TRACE)
            + f"; bf16 gradients after step 1 against one process (read, not held): tensors "
            f"{tr['grad']['tensor'][0]:.3e} ({tr['grad']['tensor'][1]}), one-element "
            f"{tr['grad']['scalar'][0]:.3e} ({tr['grad']['scalar'][1]})")
        log(f"seq train rank {rank}: f32 step {SEQ_TRAIN_SMALL} against one process on the "
            f"card: loss {sm['loss_rel']:.2e} relative (tol {SEQ_TRAIN_LOSS_TOL}); gradients: "
            f"tensors {sm['grad']['tensor'][0]:.3e} ({sm['grad']['tensor'][1]}), one-element "
            f"{sm['grad']['scalar'][0]:.3e} ({sm['grad']['scalar'][1]}; tol {TRAIN_GRAD_TOL} "
            f"both); {sm['update_off']:.2e} of the updated elements off by more than lr/2 (tol "
            f"{TRAIN_UPDATE_TOL})")
    log(f"seq train phase: {time.perf_counter() - t_phase:.1f} s ({t_ref:.1f} s of one-process "
        f"references, {wall_s:.1f} s for the group with process start)")

    if not all(res["staged"] for res in results):
        raise RuntimeError("the seq train phase expects a gloo group staged through the host")
    if len(losses) != DATA_TRAIN_STEPS or not all(np.isfinite(losses)) or not all(
            x <= DATA_BF16_LOSS_TOL for x in loss_rel):
        raise RuntimeError(f"seq losses {losses} against one process's {one['losses']}")
    for r, res in zip(readings, results):
        tr = res["train"]
        if tr["digests"] != results[0]["train"]["digests"] or len(tr["digests"]) != (
                DATA_TRAIN_STEPS):
            raise RuntimeError(f"seq train rank {r['rank']}: parameters differ from rank 0's")
        if any(step != TRAIN_LAUNCHES_PER_STEP for step in r["launches"]):
            raise RuntimeError(f"seq train rank {r['rank']}: launches per step {r['launches']}")
        for name in SEQ_TRAIN_TRACE:
            if r["traced"][name]["launches"] != TRAIN_LAUNCHES_PER_STEP[name]:
                raise RuntimeError(f"seq train rank {r['rank']}: {name} launched "
                                   f"{r['traced'][name]['launches']} times in the traced step, "
                                   f"expected {TRAIN_LAUNCHES_PER_STEP[name]}")
        if not all(step["forward"][k] > 0 and step["backward"][k] > 0
                   and step["backward"][k + "_grad"] > 0
                   for step in tr["received"] for k in ("bank", "halo", "frames")):
            raise RuntimeError(f"seq train rank {r['rank']}: a message kind received nothing "
                               f"{tr['received']}")
        sm = res["small"]
        if not (tr["grad_names"] and sm["loss_rel"] <= SEQ_TRAIN_LOSS_TOL
                and sm["grad"]["tensor"][0] <= TRAIN_GRAD_TOL
                and sm["grad"]["scalar"][0] <= TRAIN_GRAD_TOL
                and sm["update_off"] <= TRAIN_UPDATE_TOL):
            raise RuntimeError(f"seq train rank {r['rank']}: the f32 step against one process "
                               f"{sm}")
    return dict(readings=readings, one=one, one_peak_gb=one_peak_gb, losses=losses,
                loss_rel=loss_rel, wall_s=wall_s,
                launches={k: sum(step[k] for step in readings[0]["launches"])
                          for k in readings[0]["launches"][0]})


# kernel-name fragments -> the layer that launches them
_KERNEL_GROUPS = (
    ("play attention (CUDA kernel 1)", ("play_attention",)),
    ("pyramid lookup (CUDA kernel 6)", ("corr_lookup",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "splitk")),
    ("gathers and indexing", ("gather", "index", "scatter")),
    ("reductions and normalisation", ("reduce", "norm", "softmax", "welford")),
)


def phase_profile(main_run: dict, smi: str):
    """One steady 10-frame window under torch.profiler: device time by
    layer, the device's busy share, and the top kernels."""
    import torch

    video = torch.from_numpy(main_run["video"][5:5 + WINDOW]).cuda()
    return profile_window(main_run["pred"].predictor._run_window, video, f"{WINDOW}-frame",
                          smi)


def profile_window(run, video, label: str, smi: str, warm: bool = True, ranges: tuple = ()):
    """run(left, right) under torch.profiler, after one more call to warm
    unless `warm` is False (the shape has just run). `ranges`: names of
    record_function ranges the caller opened around parts of the window;
    each one's device time (the kernels launched inside it) is read too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run(video[:, 0], video[:, 1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(video[:, 0], video[:, 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # a range may also come back as a device-side annotation: it is no
    # kernel, so it is not summed
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        log("profile: the profiler saw no device time; breakdown not measured")
        return None
    range_ms = {r: max([e.device_time_total for e in averages if e.key == r and e.device_type
                        != torch.autograd.DeviceType.CUDA] or [0.0]) / 1e3 for r in ranges}
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["elementwise and other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        group = next((name for name, frags in _KERNEL_GROUPS
                      if any(f in key for f in frags)), "elementwise and other")
        groups[group] += e.self_device_time_total / 1e3
    lookups = sum(e.count for e in kernels if "corr_lookup" in e.key)
    log(f"profile of one {label} window: wall {wall_ms:.1f} ms (profiler on), "
        f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches ({lookups} of kernel 6), on {smi}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {ms:.1f} ms ({100 * ms / device_ms:.1f}% of device time)")
    for name, ms in range_ms.items():
        log(f"  range {name}: {ms:.1f} ms of device time in its kernels "
            f"({100 * ms / device_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  top kernel {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, groups=groups, ranges=range_ms,
                launches=sum(e.count for e in kernels), lookup_launches=lookups)


# ---------------------------------------------------------------- aux
# the modules that no model calls, at the widths of the shipped model at
# 320x512, window 10 (the 1/4 grid 80 x 128, the 1/16 tokens 20 x 640):
# (name, build(dtype), input shapes, the leading items the CPU reference
# runs on (None: all; the encoders are per image, so two images show the
# same function))
AUX_SEED = 17
AUX_MODULES = (
    ("FlowHead3DFFT", lambda dt: _nn("fft_head").FlowHead3DFFT(128, 256, dt),
     ((1, WINDOW, 80, 128, 128),), None),
    ("SKMotionEncoder", lambda dt: _nn("motion").SKMotionEncoder(36, (1, 15), dt),
     ((1, WINDOW, 80, 128, 2), (1, WINDOW, 80, 128, 36)), None),
    ("ResNetFPN", lambda dt: _nn("encoder").ResNetFPN(256, "instance", dt),
     ((2 * WINDOW, HEIGHT, WIDTH, 3),), 2),
    ("MultiLevelResNetFPN", lambda dt: _nn("encoder").MultiLevelResNetFPN(256, "instance", dt),
     ((2 * WINDOW, HEIGHT, WIDTH, 3),), 2),
    ("LocalFeatureTransformer full", lambda dt: _nn("attention").LocalFeatureTransformer(
        256, 8, ("self", "cross"), dt, attention="full"),
     ((2 * WINDOW, 640, 256), (2 * WINDOW, 640, 256)), None),
    ("Mlp", lambda dt: _nn("attention").Mlp(256, 1024, 256, dt), ((2 * WINDOW, 640, 256),), None),
    ("RelPosEmb", lambda dt: _nn("attention").RelPosEmb(64, 128), ((1, 1, 40, 64, 128),), None),
)
# the card's f32 output against the CPU's (TF32 off, `set_precision`):
# max |card - cpu| over max |cpu|; the fault (the LoFTR layers' linear
# attention on the full-attention weights) must exceed it
AUX_F32_TOL = 1e-4
AUX_BF16_REPS = 5
AUX_LAUNCHES = {"play_attention_fwd_kernel<0>": LAUNCHES_PER_WINDOW,
                "corr_lookup_kernel": LAUNCHES_PER_WINDOW}
AUX_READ_HW = (720, 1280)  # a Dynamic Replica / SceneFlow-size disparity and flow
AUX_READ_REPS = 5
AUX_DIR = REPO / "build" / "chip_smoke_aux"


def _nn(module: str):
    """A module of the port's `nn` package, imported when a phase needs it."""
    import importlib

    return importlib.import_module(f"ppmstereo_tpu_torch.nn.{module}")


def _aux_seeded(build, dtype, flat=None):
    """build(dtype) on the CPU with seeded weights (every parameter drawn,
    `alpha1`'s zeros included), or with `flat` carried through
    utils/weights.py; returns (module, its flat flax parameters)."""
    import torch

    from ppmstereo_tpu_torch.utils.weights import load_flax_params, model_to_flax

    torch.manual_seed(AUX_SEED)
    module = build(dtype)
    if flat is None:
        with torch.no_grad():
            for name, p in module.named_parameters():
                if not p.any():
                    p.normal_(0.0, 0.5)
        flat = model_to_flax(module)
    else:
        load_flax_params(module, flat)
    return module.eval(), flat


def _rel_max(got, want) -> float:
    import torch

    if isinstance(want, (tuple, list)):
        return max(_rel_max(g, w) for g, w in zip(got, want))
    got, want = got.detach().float().cpu(), want.detach().float()
    if not torch.isfinite(got).all():
        return math.inf
    return float((got - want).abs().max() / want.abs().max())


def _aux_module(name: str, build, shapes: tuple, cpu_items, smi: str) -> dict:
    """One module: seeded f32 weights carried into a card copy, the card's f32
    output against the CPU's on the same inputs, the bf16 copy timed."""
    import torch

    gen = torch.Generator().manual_seed(AUX_SEED)
    xs = [torch.randn(s, generator=gen) for s in shapes]
    cpu, flat = _aux_seeded(build, torch.float32)
    card = _aux_seeded(build, torch.float32, flat)[0].cuda()
    with torch.no_grad():
        want = cpu(*(x[:cpu_items] for x in xs))
        xs_card = [x.cuda() for x in xs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card(*xs_card)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        if cpu_items is not None:
            got = [g[:cpu_items] for g in got] if isinstance(got, tuple) else got[:cpu_items]
        rel = _rel_max(got, want)
        fault = None
        if name.startswith("LocalFeatureTransformer"):  # the switch's other branch
            wrong = _aux_seeded(lambda dt: _nn("attention").LocalFeatureTransformer(
                256, 8, ("self", "cross"), dt), torch.float32, flat)[0].cuda()
            fault = _rel_max(wrong(*xs_card), want)
        bf16 = _aux_seeded(build, torch.bfloat16, flat)[0].cuda()
        xs_bf16 = [x.bfloat16() for x in xs_card]
        bf16_ms = cuda_time_ms(lambda: bf16(*xs_bf16), AUX_BF16_REPS)
        out = bf16(*xs_bf16)
    outs = out if isinstance(out, tuple) else (out,)
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    log(f"aux {name} on {[tuple(s) for s in shapes]}: card f32 against the CPU "
        f"(items {cpu_items or 'all'}) {rel:.3e} of max |cpu| (tol {AUX_F32_TOL})"
        + (f", the linear-attention fault {fault:.3e}" if fault is not None else "")
        + f"; f32 first call {f32_s:.3f}s; bf16 {bf16_ms:.3f} ms a call "
        f"(mean of {AUX_BF16_REPS}), out {[tuple(o.shape) for o in outs]}, finite {finite}, "
        f"on {smi}")
    failures = []
    if not rel <= AUX_F32_TOL:
        failures.append(f"aux {name}: the card's f32 output is {rel:.3e} off the CPU's")
    if fault is not None and not fault > AUX_F32_TOL:
        failures.append(f"aux {name}: the linear-attention fault reads {fault:.3e}, inside "
                        f"the limit {AUX_F32_TOL}")
    if not finite:
        failures.append(f"aux {name}: the bf16 output is not finite")
    return dict(f32_rel=rel, fault=fault, f32_first_s=f32_s, bf16_ms=bf16_ms,
                failures=failures)


def _trace_counts(logdir: Path) -> dict:
    """The launches of each AUX_LAUNCHES kernel, and the device time of all
    kernels, in the Chrome trace the port's `trace` wrote into logdir."""
    (path,) = logdir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {frag: sum(frag in e["name"] for e in kernels) for frag in AUX_LAUNCHES}
    return dict(counts=counts, kernels=len(kernels), device_ms=sum(e["dur"] for e in kernels) / 1e3,
                trace_mb=path.stat().st_size / 1e6)


def _aux_reads(smi: str) -> dict:
    """A 720x1280 PFM disparity and FLO flow written here, read natively
    and through numpy: equal, and each reader's host ms (median)."""
    import numpy as np

    from ppmstereo_tpu_torch.data import frame_utils, native

    rng = np.random.default_rng(AUX_SEED)
    h, w = AUX_READ_HW
    pfm, flo = AUX_DIR / "disp.pfm", AUX_DIR / "flow.flo"
    frame_utils.write_pfm(str(pfm), rng.uniform(0, 200, (h, w)).astype(np.float32))
    flow = rng.standard_normal((h, w, 2)).astype(np.float32)
    with open(flo, "wb") as f:
        np.array([frame_utils.FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)
    native.available()  # the build, outside the times
    readers = {"pfm native": (native.read_pfm, pfm), "pfm numpy": (frame_utils.read_pfm, pfm),
               "flo native": (native.read_flo, flo), "flo numpy": (frame_utils.read_flow, flo)}
    ms, arrays = {}, {}
    for key, (read, path) in readers.items():
        times = []
        for _ in range(AUX_READ_REPS):
            t0 = time.perf_counter()
            arrays[key] = read(str(path))
            times.append((time.perf_counter() - t0) * 1e3)
        ms[key] = sorted(times)[len(times) // 2]
    equal = {kind: bool(np.array_equal(arrays[f"{kind} native"], arrays[f"{kind} numpy"]))
             for kind in ("pfm", "flo")}
    log(f"aux reads of a {h}x{w} disparity (PFM) and flow (FLO): equal {equal}; host ms "
        f"(median of {AUX_READ_REPS}) " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; on the host of {smi}")
    return dict(equal=equal, ms=ms)


def phase_aux(main_run: dict, smi: str, kernel1_ms: float) -> dict:
    """The modules no model calls at full width (f32 against the CPU, bf16
    timed); one steady main-path window timed with the port's `timed` and
    traced with its `trace` (kernels 1 and 6 counted in the written trace);
    the roofline of `utils/profiling.py` beside kernel 1's time (phase
    kernels, `kernel1_ms`) and the window's device time; the native readers
    on a 720p PFM and FLO."""
    import torch

    from ppmstereo_tpu_torch.utils import profiling

    failures = []
    modules = {}
    for name, build, shapes, cpu_items in AUX_MODULES:
        modules[name] = _aux_module(name, build, shapes, cpu_items, smi)
        failures += modules[name]["failures"]
        torch.cuda.empty_cache()

    run = main_run["pred"].predictor._run_window
    video = torch.from_numpy(main_run["video"][5:5 + WINDOW]).cuda()
    shutil.rmtree(AUX_DIR, ignore_errors=True)
    AUX_DIR.mkdir(parents=True)
    run(video[:, 0], video[:, 1])
    timings = {}
    with profiling.timed("window", timings, device="cuda"):
        run(video[:, 0], video[:, 1])
    with profiling.trace(str(AUX_DIR / "trace")):
        run(video[:, 0], video[:, 1])
        torch.cuda.synchronize()
    traced = _trace_counts(AUX_DIR / "trace")
    if traced["counts"] != AUX_LAUNCHES:
        failures.append(f"aux: the trace holds {traced['counts']} launches, want {AUX_LAUNCHES}")
    play = profiling.play_attention_cost(1, WINDOW, 80 * 128, 5, 128)
    iteration = profiling.ppm_iteration_cost(1, WINDOW, 80, 128)
    log(f"aux window of {WINDOW} frames: {timings['window']:.3f}s (profiling.timed, "
        f"device=cuda); traced: {traced['kernels']} kernels, {traced['device_ms']:.1f} ms of "
        f"device time, launches {traced['counts']} (want {AUX_LAUNCHES}), trace "
        f"{traced['trace_mb']:.1f} MB; on {smi}")
    log(f"aux roofline (profiling.OpCost, H100 peaks {profiling.H100_BF16_FLOPS:.3g} FLOP/s, "
        f"{profiling.H100_HBM_BYTES_S:.3g} B/s): play_attention_cost at the 1/4 shape "
        f"{play.flops:.4g} FLOP, {play.bytes / 1e6:.1f} MB, light speed "
        f"{play.light_speed_s * 1e3:.3f} ms ({play.bound}); kernel 1 {kernel1_ms:.3f} ms, "
        f"{100 * play.light_speed_s * 1e3 / kernel1_ms:.1f}% of light speed; "
        f"ppm_iteration_cost(1, {WINDOW}, 80, 128) {iteration.flops:.4g} FLOP, "
        f"{iteration.bytes / 1e6:.1f} MB, light speed {iteration.light_speed_s * 1e3:.3f} ms "
        f"({iteration.bound}), x{ITERS} iterations {ITERS * iteration.light_speed_s * 1e3:.3f} "
        f"ms against the window's {traced['device_ms']:.1f} ms of device time; on {smi}")
    reads = _aux_reads(smi)
    if not all(reads["equal"].values()):
        failures.append(f"aux: the native readers differ from numpy: {reads['equal']}")
    shutil.rmtree(AUX_DIR, ignore_errors=True)
    if failures:
        raise RuntimeError("; ".join(failures))
    return dict(modules=modules, window_s=timings["window"], traced=traced,
                play_light_ms=play.light_speed_s * 1e3, kernel1_ms=kernel1_ms,
                iteration_light_ms=iteration.light_speed_s * 1e3, reads=reads)


# ---------------------------------------------------------------- modes
# the window modes of `model_zoo` on the main path's clip (320x512, window
# 10, 10 iterations, bf16, the anchor): (name, model_zoo keyword arguments)
WARM_ITERS = ITERS
MODES = (
    ("strict", {}),
    ("batch_windows=2", {"batch_windows": 2}),
    ("encoder_cache", {"encoder_cache": True}),
    ("fast_mode", {"fast_mode": True}),
    ("warm_start", {"warm_start": True, "warm_iters": WARM_ITERS}),
    ("warm_start+encoder_cache", {"warm_start": True, "warm_iters": WARM_ITERS,
                                  "encoder_cache": True}),
)
# batch_windows=2 and encoder_cache are strict by design. The encoder cache
# gives the strict run's bits (the zoo's predictor encodes each frame in the
# same call in every window), and must. A batch of two windows need not: the
# encoders of a batch part first (tools/window_bits.py), and in bf16 a
# last-bit difference grows through 30 iterations (the ring's reordering
# alone moved single pixels by up to 0.93 px, mean 5.8e-3 px, with the same
# EPE). Limits: mean |disparity difference| STRICT_MEAN_TOL px and |EPE
# difference| STRICT_EPE_TOL px; the largest difference is printed.
STRICT_MEAN_TOL = 0.02
STRICT_EPE_TOL = 0.01
# the modes that are not strict by design are held to the main path's bound
NON_PARITY = ("fast_mode", "warm_start", "warm_start+encoder_cache")
BIT_EQUAL_MODES = ("encoder_cache",)
_RUNNERS = ("_run_window", "_run_window_batch", "_run_window_cached", "_run_window_warm",
            "_run_window_warm_cached")


def timed_windows(pred) -> list:
    """Patch every window runner of the predictor so that each call is
    timed under torch.cuda.synchronize() and records kernel 1's and kernel
    6's launches; returns the list the records go to."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa

    records = []
    for name in _RUNNERS:
        fn = getattr(pred.predictor, name)

        def timed(*args, _fn=fn, _name=name):
            torch.cuda.synchronize()
            play, lookup = pa.play_attention.launches, kl.corr_lookup_kernel.launches
            t0 = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()
            records.append(dict(runner=_name, s=time.perf_counter() - t0,
                                windows=args[0].shape[0] if _name == "_run_window_batch" else 1,
                                frames=args[0].shape[-4],
                                play=pa.play_attention.launches - play,
                                lookup=kl.corr_lookup_kernel.launches - lookup))
            return out

        setattr(pred.predictor, name, timed)
    return records


def sequence_metrics(disp, gt) -> dict:
    """EPE, TEPE and bad-px of a (T, H, W, 1) disparity against (T, H, W),
    every pixel valid (the port's evaluator metrics)."""
    import numpy as np

    from ppmstereo_tpu_torch.evaluation.metrics import eval_endpoint_error_sequence

    gt = gt[..., None]
    return eval_endpoint_error_sequence(disp, gt, np.ones_like(gt))


def phase_modes(main_run: dict, smi: str):
    """Every window mode of `model_zoo` on the main path's clip: each run
    twice (the second timed and counted), with its seconds per window,
    frames per second, kernel 1 and 6 launches, EPE/TEPE and peak memory;
    the strict modes held against the strict run, the others to the EPE
    bound, and every warm window after the first launching kernel 1
    WARM_ITERS times."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.utils.weights import load_npz

    video, gt = main_run["video"], main_run["gt"]
    params = load_npz(ANCHOR)
    runs = {}
    for name, kwargs in MODES:
        pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, params=params,
                         **kwargs)
        pred({"stereo_video": video})  # warm
        records = timed_windows(pred)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
        t0 = time.perf_counter()
        out = pred({"stereo_video": video})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        play, lookup = pa.play_attention.launches, kl.corr_lookup_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        disp = out["disparity"]
        if disp.shape != (CLIP_FRAMES, HEIGHT, WIDTH, 1) or not np.isfinite(disp).all():
            raise RuntimeError(f"mode {name}: disparity of shape {disp.shape} or not finite")
        metrics = sequence_metrics(disp, gt)
        n_windows = sum(r["windows"] for r in records)
        s_per_window = sum(r["s"] for r in records) / n_windows  # every window is warm
        run = dict(wall_s=wall, fps=CLIP_FRAMES / wall, s_per_window=s_per_window,
                   windows=n_windows, calls=[(r["runner"], round(r["s"], 4), r["play"],
                                              r["lookup"]) for r in records],
                   play_launches=play, lookup_launches=lookup, peak_gb=peak_gb,
                   epe=metrics["epe_mean"], tepe=metrics["temp_epe_mean"],
                   bad_1px=metrics["epe_bad_1px"])
        log(f"mode {name} on {smi}: {n_windows} windows in {len(records)} calls, "
            f"{s_per_window:.3f} s per window (the second run), {run['fps']:.2f} frames/s ({wall:.3f} s for "
            f"{CLIP_FRAMES} frames), kernel 1 launches {play}, kernel 6 launches {lookup}, "
            f"EPE {run['epe']:.4f} px, TEPE {run['tepe']:.4f} px, bad-1px "
            f"{run['bad_1px']:.3f} %, peak {peak_gb:.2f} GB; calls (runner, s, kernel 1, "
            f"kernel 6): {run['calls']}")
        if play != lookup or play != sum(r["play"] for r in records):
            raise RuntimeError(f"mode {name}: kernel 1 launched {play} times, kernel 6 {lookup}")
        if name.startswith("warm_start"):
            per_window = [r["play"] for r in records]
            want = [LAUNCHES_PER_WINDOW] + [WARM_ITERS] * (len(records) - 1)
            if per_window != want:
                raise RuntimeError(f"mode {name}: kernel 1 launches per window {per_window}, "
                                   f"expected {want}")
        if name == "strict":
            ref = disp
        else:
            diff = np.abs(disp - ref)
            run.update(max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
                       bit_equal=bool(np.array_equal(disp, ref)),
                       epe_diff=abs(run["epe"] - runs["strict"]["epe"]))
            log(f"  against strict: bit-equal {run['bit_equal']}, max |diff| "
                f"{run['max_abs_diff']:.3e} px, mean {run['mean_abs_diff']:.3e} px, |EPE diff| "
                f"{run['epe_diff']:.2e} px")
            if name not in NON_PARITY and not (run["mean_abs_diff"] <= STRICT_MEAN_TOL
                                               and run["epe_diff"] <= STRICT_EPE_TOL):
                raise RuntimeError(f"mode {name} is strict by design but differs from the "
                                   f"strict run by {run['mean_abs_diff']:.3e} px on average")
            if name in BIT_EQUAL_MODES and not run["bit_equal"]:
                raise RuntimeError(f"mode {name} is not bit-equal to the strict run (max "
                                   f"|diff| {run['max_abs_diff']:.3e} px)")
        if not run["epe"] <= EPE_BOUND_PX:
            raise RuntimeError(f"mode {name}: EPE {run['epe']:.3f} px exceeds {EPE_BOUND_PX}")
        runs[name] = run
        del pred, out
        torch.cuda.empty_cache()
    for name, run in runs.items():
        n = len(window_frames(CLIP_FRAMES, WINDOW, fast=name == "fast_mode"))
        if run["windows"] != n:  # 4 windows (2 in fast mode) at 20 frames, window 10
            raise RuntimeError(f"mode {name} ran {run['windows']} windows, expected {n}")
    return runs


def window_frames(frames: int, k: int, fast: bool = False) -> list:
    """The lengths of the sliding-window predictor's windows over a clip:
    stride k // 2 (k in fast mode), a tail shorter than a stride skipped."""
    stride = k if fast else k // 2
    lengths = [min(k, frames - i) for i in range(0, frames, stride)]
    return [n for i, n in enumerate(lengths) if fast or i == 0 or n >= stride]


# ---------------------------------------------------------------- config
# two non-default PPMStereoConfig's at full width (phase config): A, the JAX
# package's multi-device configuration (no context net, no attention, every
# frame of the window picked), and B (the 2-D convex upsample, a 3-level
# radius-3 lookup, two SST rounds). No checkpoint exists for them: the
# weights are the port's initialisation from a seed, with every play blend
# `beta` set to 1 and the SST time embedding drawn (both start at zero, and
# the play step would not reach the output)
CONFIGS = (
    ("A", {"use_cnet": False, "attention_type": None, "top_k": WINDOW}),
    ("B", {"use_convex_3d": False, "corr_levels": 3, "corr_radius": 3, "sst_depth": 2}),
)
CONFIG_SEED = 11
# one strict window through the kernels against the same window with every
# kernel swapped for its plain function (bf16): kernel 6 is bit-equal to
# its plain version, kernel 1 differs from its plain play by a bf16 ulp in
# places, and that grows through 20 iterations. The weights are untrained,
# so the disparity's scale is not known beforehand: the limit is on the mean
# |difference| relative to the plain run's mean |disparity|. A wrong lookup
# (its fractional weights swapped; through the plain functions) must fail
# it; the max |difference| is printed. An untrained model barely reads its
# play step (the values' tokens reversed moved configuration A by 8.5e-4 of
# its disparity, kernel 1 against the plain play 4.5e-4), so kernel 1 is
# also held call by call against the plain play on the same inputs, with
# phase kernels' limits, and kernel 6 bit for bit. Untrained q and k give a
# near-uniform softmax, which no fault of the play moves past those limits
# in every call (a doubled scale was caught in 10 of 20, the keys' second
# half dropped in 15): the fault reading is taken at each play shape of the
# window on random inputs, as phase kernels takes it
CONFIG_REL_TOL = 0.01


def _play_at_shape(label: str, b: int, lq: int, lk: int) -> dict:
    """Kernel 1 at (B, Lq, Lk) on random inputs against its plain version,
    with phase kernels' limits and its fault (the softmax scale doubled)."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(b * 7 + lq)
    q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
    k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
    v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
    got = pa.play_attention(q, k, v, scale)
    ref = pa.play_attention_plain(q, k, v, scale)
    fault = pa.play_attention_plain(q, k, v, 2 * scale)
    o_tol = 2**-7 * ref.float().abs().max().item() + 2**-8 * v.float().abs().max().item()
    return _agreement(f"{label} B={b} Lq={lq} Lk={lk}", "play_attention_fwd", got, ref, fault,
                      o_tol, 2**-8 * ref.float().abs().mean().item())


def _play_blends_on(model, seed: int) -> None:
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("aggregator.beta"):
                p.fill_(1.0)
            elif name.endswith("time_embed"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)


def _kernel_swaps(calls: list):
    """The swaps of `models/ppm_stereo.py`'s kernel functions: (checked,
    plain, fault). `checked` launches each kernel and holds its output
    against its plain function on the same inputs, appending (kernel, share
    of the max limit, share of the mean limit, play shape (B.T, Lk, Lq)) to
    `calls`: kernel 1 with phase kernels' limits, 2^-7 max|out| + 2^-8
    max|v| and 2^-8 mean|out| (bf16 outputs), kernel 6 bit for bit (share 0,
    else inf). `plain` runs both plain functions; `fault` is `plain` with a
    wrong lookup (its fractional weights swapped)."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    plain = {"play_attention": pa.play_attention_plain,
             "corr_lookup_kernel": lambda pyr, x, radius, out_dtype: corr_lookup(
                 pyr, x, radius).to(out_dtype)}
    fault = dict(plain, corr_lookup_kernel=lambda pyr, x, radius, out_dtype: _lookup_fault(
        pyr, x, radius).to(out_dtype))

    def checked_play(q, k, v, scale):
        out = pa.play_attention(q, k, v, scale)
        want = pa.play_attention_plain(q, k, v, scale).float()
        tol = 2**-7 * want.abs().max().item() + 2**-8 * v.float().abs().max().item()
        mean_tol = 2**-8 * want.abs().mean().item()
        diff = (out.float() - want).abs()
        calls.append(("play", diff.max().item() / tol, diff.mean().item() / mean_tol,
                      tuple(k.shape[:2]) + (q.shape[1],)))
        return out

    def checked_lookup(pyr, x, radius, out_dtype):
        out = kl.corr_lookup_kernel(pyr, x, radius, out_dtype=out_dtype)
        equal = torch.equal(out, corr_lookup(pyr, x, radius).to(out_dtype))
        calls.append(("lookup", 0.0 if equal else float("inf"), 0.0, None))
        return out

    return {"play_attention": checked_play, "corr_lookup_kernel": checked_lookup}, plain, fault


def phase_config(main_run: dict, smi: str):
    """Each of CONFIGS at 320x512: one strict window (frames 5-14, window
    10, 10 iterations, bf16) through `model_zoo` with the kernels (the
    second of two runs timed and counted: kernels 1 and 6 launched
    LAUNCHES_PER_WINDOW times each); once more with every kernel call held
    against its plain function on the same inputs; then with every kernel
    swapped for its plain function, and that run with a wrong lookup."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models import ppm_stereo
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    clip = torch.from_numpy(main_run["video"][5:5 + WINDOW]).cuda()
    gt = main_run["gt"][5:5 + WINDOW]
    calls = []  # (kernel, share of the max limit, of the mean limit, play shape)
    checked, plain, fault = _kernel_swaps(calls)
    runs = {}
    for name, kwargs in CONFIGS:
        pred = model_zoo("PPMStereoModel", kernel_size=WINDOW, iters=ITERS, seed=CONFIG_SEED,
                         **kwargs)
        _play_blends_on(pred.model, CONFIG_SEED)
        run = pred.predictor._run_window
        out = {}
        calls.clear()
        for label, swap in (("kernels", {}), ("checked", checked), ("plain", plain),
                            ("fault", fault)):
            saved = {k: getattr(ppm_stereo, k) for k in swap}
            try:
                for k, fn in swap.items():
                    setattr(ppm_stereo, k, fn)
                if label == "kernels":
                    run(clip[:, 0], clip[:, 1])  # warm
                torch.cuda.synchronize()
                pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
                t0 = time.perf_counter()
                disp = run(clip[:, 0], clip[:, 1])[0]
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            finally:
                for k, fn in saved.items():
                    setattr(ppm_stereo, k, fn)
            out[label] = dict(disp=disp.float().cpu().numpy()[..., 0], s=seconds,
                              play=pa.play_attention.launches,
                              lookup=kl.corr_lookup_kernel.launches)
        plays = [c for c in calls if c[0] == "play"]
        lookups = [c for c in calls if c[0] == "lookup"]
        worst = (max(c[1] for c in plays), max(c[2] for c in plays))
        shapes = sorted({c[3] for c in plays})  # (B.T, Lk, Lq) of each stage
        random_checks = [_play_at_shape(f"config {name}", b, lq, lk)
                         for b, lk, lq in shapes]
        k_run, p_run, f_run = out["kernels"], out["plain"], out["fault"]
        diff = np.abs(k_run["disp"] - p_run["disp"])
        scale = float(np.abs(p_run["disp"]).mean())
        rel = float(diff.mean()) / scale
        fault_rel = float(np.abs(f_run["disp"] - p_run["disp"]).mean()) / scale
        epe = float(np.abs(np.abs(k_run["disp"]) - gt).mean())
        runs[name] = dict(kwargs=kwargs, s=k_run["s"], plain_s=p_run["s"],
                          play_launches=k_run["play"], lookup_launches=k_run["lookup"],
                          max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
                          mean_abs_disp=scale, rel_diff=rel, fault_rel_diff=fault_rel, epe=epe,
                          play_calls_worst_share=worst, lookup_calls_bit_equal=all(
                              c[1] == 0.0 for c in lookups), play_shapes=shapes,
                          play_random_checks=random_checks)
        log(f"config {name} {kwargs} at {HEIGHT}x{WIDTH}, a strict window of {WINDOW} frames, "
            f"{ITERS} iterations, bf16, on {smi}: {k_run['s']:.3f} s (plain functions "
            f"{p_run['s']:.3f} s); kernel 1 launches {k_run['play']}, kernel 6 launches "
            f"{k_run['lookup']}; against the plain functions: max |diff| {diff.max():.3e} px, "
            f"mean {diff.mean():.3e} px = {rel:.2e} of the mean |disparity| {scale:.4f} px "
            f"(limit {CONFIG_REL_TOL}); a wrong lookup: {fault_rel:.2e}; EPE {epe:.3f} px "
            f"(untrained weights); call by call: {len(plays)} kernel 1 calls against the "
            f"plain play at worst {worst[0]:.2f} / {worst[1]:.2f} of the max / mean limits, "
            f"{len(lookups)} kernel 6 calls bit-equal {runs[name]['lookup_calls_bit_equal']}; "
            f"kernel 1 at the play shapes (B.T, Lk, Lq) {shapes} on random inputs, each within "
            f"its limits with the doubled-scale fault caught")
        if (k_run["play"], k_run["lookup"]) != (LAUNCHES_PER_WINDOW,) * 2 or \
                (p_run["play"], p_run["lookup"]) != (0, 0):
            raise RuntimeError(f"config {name}: kernel launches {k_run['play']}, "
                               f"{k_run['lookup']} (plain run: {p_run['play']}, "
                               f"{p_run['lookup']}), expected {LAUNCHES_PER_WINDOW} and 0")
        if not np.isfinite(k_run["disp"]).all() or not rel <= CONFIG_REL_TOL:
            raise RuntimeError(f"config {name}: the kernels' window differs from the plain "
                               f"functions' by {rel:.2e} of the mean |disparity|")
        if not fault_rel > CONFIG_REL_TOL:
            raise RuntimeError(f"config {name}: a wrong lookup moves the window by "
                               f"{fault_rel:.2e} of the mean |disparity| only; the limit "
                               "cannot catch it")
        if (len(plays), len(lookups)) != (LAUNCHES_PER_WINDOW,) * 2 or not (
                worst[0] <= 1 and worst[1] <= 1 and runs[name]["lookup_calls_bit_equal"]):
            raise RuntimeError(f"config {name}: kernel 1 at worst {worst} of its limits over "
                               f"{len(plays)} calls, kernel 6 bit-equal "
                               f"{runs[name]['lookup_calls_bit_equal']} over {len(lookups)}")
        del pred
        torch.cuda.empty_cache()
    _head_dim_refused(smi)
    return runs


def _head_dim_refused(smi: str) -> None:
    """The play kernels take head dim 128 only (PPMStereoConfig refuses
    another context_dim when it is built): on the card a head dim of 64 or
    256 raises in kernel 1 and in the training path and launches nothing."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    counters = (pa.play_attention, pa.play_attention_fwd_res)
    before = [c.launches for c in counters]
    for d in (64, 256):
        x = torch.zeros(2, 64, d, device="cuda", dtype=torch.bfloat16)
        for q in (x, x.clone().requires_grad_()):
            try:
                pa.play_attention(q, x, x, 0.1)
            except ValueError:
                continue
            raise RuntimeError(f"the play took head dim {d} on the card")
    if [c.launches for c in counters] != before:
        raise RuntimeError("a refused head dim launched a play kernel")
    log(f"play head dims 64 and 256 raise on {smi}, with and without a gradient; "
        "no play kernel launched")


# ------------------------------------------------------------------- zoo
# the zoo's baselines at their shipped configurations (full width, the
# shipped dtype and iterations), untrained: no checkpoint of them is in the
# repository, so their weights are the port's initialisation from ZOO_SEED.
# (name, iterations, kernel 6 launches a window): DynamicStereo looks up
# once an iteration of its three stages (10 + 10 + 20), RAFT-Stereo once an
# iteration for the whole folded window, BiDAStereo correlates by TFCL
ZOO_MODELS = (("DynamicStereoModel", 20, 40), ("RAFTStereoModel", 32, 32),
              ("BiDAStereoModel", 10, 0))
# each model's window size: BiDAStereo's is cut to 256x384 (a crop of the
# clip), since the phase took 106 s on an H100 with all three at 320x512
# (BiDAStereo's window 0.93 s, its first call 16.1 s: cuDNN's algorithm
# search, see utils/device.py::cudnn_autotune), over the 90 s it may take
ZOO_HW = {"DynamicStereoModel": (HEIGHT, WIDTH), "RAFTStereoModel": (HEIGHT, WIDTH),
          "BiDAStereoModel": (256, 384)}
ZOO_SEED = 5
ZOO_FRAMES = 10  # one strict window of the main clip's frames 5-14
ZOO_SMALL = (5, 64, 128)  # the small parity's clip: frames, height, width
# small parity, the card's f32 path against the port's CPU path: the same
# operations in f32 on two devices (no TF32) part by rounding only, through
# 20-32 recurrent iterations of an untrained model. A lookup read one pixel
# to the right (DynamicStereo, RAFT-Stereo) must fail both limits.
ZOO_SMALL_MAX_TOL = 1e-3  # px
ZOO_SMALL_MEAN_TOL = 1e-4  # px
# profiler ranges opened around BiDAStereo's plain parts: (module or class,
# attribute, range name); its frozen RAFT, RAFT's 2-D pyramid and lookup
# inside it, TFCL and the flow warps
ZOO_RANGES = (("bidastereo", "BiDAStereo.compute_flows", "zoo raft"),
              ("raft", "build_corr_pyramid_2d", "zoo raft 2-D pyramid"),
              ("raft", "corr_lookup_2d", "zoo raft 2-D lookup"),
              ("bidastereo", "tfcl_correlation", "zoo tfcl"),
              ("bidastereo", "flow_warp", "zoo flow warp"))
# the `real` evaluation preset (ppmstereo_tpu_torch/configs/eval_real.yaml:
# DynamicStereoModel, 40 frames, window 20, 20 iterations, bf16) at
# 720x1280 on a Dynamic Replica-layout real/<sequence> tree
REAL_PRESET = REPO / "ppmstereo_tpu_torch" / "configs" / "eval_real.yaml"
REAL_SEQUENCE = "teddy_static"


def _shifted_lookup(pyramid, x, radius, out_dtype):
    """The fault of the zoo's small parity: kernel 6 read one pixel to the
    right."""
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl

    return kl.corr_lookup_kernel(pyramid, x + 1.0, radius, out_dtype=out_dtype)


def _plain_lookup(pyramid, x, radius, out_dtype):
    from ppmstereo_tpu_torch.ops.corr import corr_lookup

    return corr_lookup(pyramid, x, radius).to(out_dtype)


@contextmanager
def _patched(module, name: str, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextmanager
def _zoo_ranges():
    """record_function ranges around ZOO_RANGES' functions, for the profile."""
    import torch

    from ppmstereo_tpu_torch.models import bidastereo, raft

    modules = {"bidastereo": bidastereo, "raft": raft}
    saved = []
    for mod_name, path, label in ZOO_RANGES:
        *owners, attr = path.split(".")
        owner = modules[mod_name]
        for name in owners:
            owner = getattr(owner, name)
        fn = getattr(owner, attr)

        def ranged(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((owner, attr, fn))
        setattr(owner, attr, ranged)
    try:
        yield tuple(label for _, _, label in ZOO_RANGES)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _zoo_small_parity(name: str, iters: int, lookup_module, smi: str) -> dict:
    """The model at its shipped iterations in f32 on a small clip: the
    card against the port's CPU path, and (with `lookup_module`) the card
    with kernel 6 read one pixel to the right."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.models.zoo import model_zoo

    torch.set_num_threads(8)
    video, _ = synthetic_clip(*ZOO_SMALL, seed=2)
    left, right = torch.from_numpy(video[:, 0]), torch.from_numpy(video[:, 1])
    outs = {}
    for run, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        pred = model_zoo(name, kernel_size=WINDOW, iters=iters, seed=ZOO_SEED, device=dev,
                         mixed_precision=False)
        outs[run] = pred.predictor._run_window(left.to(dev), right.to(dev))[0].cpu().numpy()
        if run == "cuda" and lookup_module is not None:
            with _patched(lookup_module, "corr_lookup_kernel", _shifted_lookup):
                outs["fault"] = pred.predictor._run_window(left.cuda(), right.cuda())[0]
            outs["fault"] = outs["fault"].cpu().numpy()
        del pred
    diff = np.abs(outs["cuda"] - outs["cpu"])
    scale = float(np.abs(outs["cpu"]).mean())
    res = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()), mean_abs_disp=scale)
    msg = (f"zoo {name} small clip {ZOO_SMALL}, f32, {iters} iterations, on {smi}: cuda vs "
           f"cpu max |disparity diff| {res['max_abs']:.3e} px (limit {ZOO_SMALL_MAX_TOL}), "
           f"mean {res['mean_abs']:.3e} px (limit {ZOO_SMALL_MEAN_TOL}); mean |disparity| "
           f"{scale:.4f} px")
    if "fault" in outs:
        fd = np.abs(outs["fault"] - outs["cpu"])
        res.update(fault_max_abs=float(fd.max()), fault_mean_abs=float(fd.mean()))
        msg += (f"; the lookup one pixel to the right reads {res['fault_max_abs']:.3e} / "
                f"{res['fault_mean_abs']:.3e} px")
    log(msg)
    if not np.isfinite(outs["cuda"]).all() or not (
            res["max_abs"] <= ZOO_SMALL_MAX_TOL and res["mean_abs"] <= ZOO_SMALL_MEAN_TOL):
        raise RuntimeError(f"zoo {name}: the card's f32 path disagrees with the CPU path on "
                           "the small clip")
    if "fault" in outs and not (res["fault_max_abs"] > ZOO_SMALL_MAX_TOL
                                and res["fault_mean_abs"] > ZOO_SMALL_MEAN_TOL):
        raise RuntimeError(f"zoo {name}: the small-clip limits do not catch a shifted lookup")
    return res


def phase_zoo(main_run: dict, smi: str):
    """Each of ZOO_MODELS: the small parity (card f32 against the CPU
    path); one strict window of ZOO_FRAMES frames at ZOO_HW through
    `model_zoo` in the shipped dtype, the second of two calls timed and
    counted (kernel 6's launches required), with its peak memory and a
    profiled third call; for DynamicStereo and RAFT-Stereo the window again
    with the plain lookup in kernel 6's place, bit-equal required. Then
    DynamicStereoModel through run_eval with the `real` preset (phase_real)."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.models import dynamic_stereo, raft_stereo
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    lookup_modules = {"DynamicStereoModel": dynamic_stereo, "RAFTStereoModel": raft_stereo}
    steady = main_run["window_s"][1:] or main_run["window_s"]
    ppm_s = sum(steady) / len(steady)
    runs = {}
    for name, iters, launches_per_window in ZOO_MODELS:
        h, w = ZOO_HW[name]
        clip = torch.from_numpy(main_run["video"][5:5 + ZOO_FRAMES, :, :h, :w]).cuda()
        lookup_module = lookup_modules.get(name)
        small = _zoo_small_parity(name, iters, lookup_module, smi)
        pred = model_zoo(name, kernel_size=WINDOW, iters=iters, seed=ZOO_SEED)
        dtype = str(pred.model.dtype).removeprefix("torch.")
        run = pred.predictor._run_window
        t0 = time.perf_counter()
        run(clip[:, 0], clip[:, 1])  # the first call: cuDNN's algorithm search, allocations
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kl.corr_lookup_kernel.launches = 0
        t0 = time.perf_counter()
        disp = run(clip[:, 0], clip[:, 1])[0]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches = kl.corr_lookup_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        disp = disp.float().cpu().numpy()
        if disp.shape != (ZOO_FRAMES, h, w, 1) or not np.isfinite(disp).all():
            raise RuntimeError(f"zoo {name}: disparity of shape {disp.shape} or not finite")
        if launches != launches_per_window:
            raise RuntimeError(f"zoo {name}: kernel 6 launched {launches} times in a window, "
                               f"expected {launches_per_window}")
        mean_disp = float(np.abs(disp).mean())
        log(f"zoo {name} at {h}x{w}, a strict window of {ZOO_FRAMES} frames, {iters} "
            f"iterations, {dtype}, seeded weights, on {smi}: {window_s:.3f} s (the first call "
            f"{first_s:.3f} s; PPMStereo's steady window in phase main {ppm_s:.3f} s), peak "
            f"{peak_gb:.2f} GB, kernel 6 launches {launches}, mean |disparity| "
            f"{mean_disp:.4f} px")
        rec = dict(hw=(h, w), dtype=dtype, iters=iters, window_s=window_s, first_s=first_s,
                   ppm_window_s=ppm_s, peak_gb=peak_gb, lookup_launches=launches,
                   mean_abs_disp=mean_disp, small=small)
        if lookup_module is not None:
            with _patched(lookup_module, "corr_lookup_kernel", _plain_lookup):
                kl.corr_lookup_kernel.launches = 0
                plain = run(clip[:, 0], clip[:, 1])[0].float().cpu().numpy()
                plain_launches = kl.corr_lookup_kernel.launches
            rec["plain_lookup_bit_equal"] = bool(np.array_equal(disp, plain))
            diff = float(np.abs(disp - plain).max())
            log(f"  the same window with the plain lookup in kernel 6's place: bit-equal "
                f"{rec['plain_lookup_bit_equal']} (max |diff| {diff:.3e} px), kernel 6 launches "
                f"{plain_launches}")
            if plain_launches != 0 or not rec["plain_lookup_bit_equal"]:
                raise RuntimeError(f"zoo {name}: the window through kernel 6 differs from the "
                                   f"plain lookup's by up to {diff:.3e} px")
        with _zoo_ranges() as ranges:
            rec["profile"] = profile_window(run, clip, f"{ZOO_FRAMES}-frame {name}", smi,
                                            warm=False,
                                            ranges=ranges if name == "BiDAStereoModel" else ())
        runs[name] = rec
        del pred
        torch.cuda.empty_cache()
    runs["real"] = phase_real(smi)
    return runs


def phase_real(smi: str) -> dict:
    """DynamicStereoModel through the evaluate CLI's run_eval with the port's
    `real` preset, on a Dynamic Replica-layout `real/<REAL_SEQUENCE>` tree
    written from a synthetic 720x1280 clip: fps, seconds and kernel 6
    launches per window, peak memory."""
    import tempfile

    import torch

    from ppmstereo_tpu_torch.cli import evaluate as cli
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.utils.config import load_yaml

    video, gt = synthetic_clip(EVAL_FRAMES, EVAL_HEIGHT, EVAL_WIDTH, seed=4)
    with tempfile.TemporaryDirectory() as tmp:
        write_dynamic_replica_tree(Path(tmp), video, gt, split_name="test",
                                   subdir=f"real/{REAL_SEQUENCE}")
        cfg = load_yaml(cli.DefaultConfig, str(REAL_PRESET), overrides=[
            f"dataset_root={tmp}", f"exp_dir={tmp}/out"])
        if (cfg.dataset_name, cfg.MODEL.model_name, cfg.sample_len, cfg.MODEL.kernel_size,
                cfg.MODEL.iters) != ("real", "DynamicStereoModel", EVAL_FRAMES, EVAL_WINDOW,
                                     EVAL_ITERS):
            raise RuntimeError(f"the real preset is not DynamicStereo's 40-frame protocol: {cfg}")
        captured = {}
        zoo = cli.model_zoo

        def capturing_zoo(*args, **kwargs):
            pred = zoo(*args, seed=ZOO_SEED, **kwargs)
            captured["records"] = timed_windows(pred)
            return pred

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kl.corr_lookup_kernel.launches = 0
        with _patched(cli, "model_zoo", capturing_zoo):
            t0 = time.perf_counter()
            results = cli.run_eval(cfg)
            eval_s = time.perf_counter() - t0
        lookup = kl.corr_lookup_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if set(results) != {REAL_SEQUENCE}:
        raise RuntimeError(f"run_eval's real branch evaluated {sorted(results)}")
    agg = results[REAL_SEQUENCE]["aggregate"]
    records = captured["records"]
    frames = window_frames(EVAL_FRAMES, EVAL_WINDOW)  # 20, 20, 20, 10
    log(f"real preset (DynamicStereoModel, {EVAL_FRAMES} frames at {EVAL_HEIGHT}x{EVAL_WIDTH}, "
        f"window {EVAL_WINDOW}, {EVAL_ITERS} iterations, bf16, seeded weights) through run_eval "
        f"on {smi}: {eval_s:.1f} s, fps {agg['fps']:.3f}; seconds per window "
        f"{[round(r['s'], 3) for r in records]}, kernel 6 launches {lookup} "
        f"({[r['lookup'] for r in records]}); peak {peak_gb:.2f} GB")
    want = [2 * (EVAL_ITERS // 2) + EVAL_ITERS] * len(frames)
    if [r["lookup"] for r in records] != want or [r["frames"] for r in records] != frames:
        raise RuntimeError(f"real preset windows {[(r['frames'], r['lookup']) for r in records]}"
                           f", expected {frames} frames, {want[0]} launches each")
    return dict(fps=agg["fps"], eval_s=eval_s, window_s=[r["s"] for r in records],
                lookup_launches=lookup, peak_gb=peak_gb)


# ------------------------------------------------------------------- vda
# the Video-Depth-Anything family at its shipped configurations (ViT-S),
# untrained (the port's seeded initialisation): (model, iterations, launches
# of kernels 1 and 6 in a window each). PPMStereo-VDA plays and looks up once
# an iteration of its three stages (10 + 10 + 20); StereoAnyVideo correlates
# by AAPC (plain PyTorch) and launches neither
VDA_MODELS = (("PPMStereoVDAModel", 20, 40), ("StereoAnyVideoModel", 12, 0))
# each model's window: one strict window of the main clip's frames 5-14
VDA_HW = {"PPMStereoVDAModel": (HEIGHT, WIDTH), "StereoAnyVideoModel": (HEIGHT, WIDTH)}
VDA_STEADY_CALLS = 3  # a window's steady seconds: the median of these calls
# profiler ranges: the backbone's forward (DINOv2 and the DPT head), and
# StereoAnyVideo's AAPC
VDA_RANGE, AAPC_RANGE = "vda backbone", "vda aapc"
# PPMStereo-VDA's window through the kernels against the same window through
# the plain functions, by the mean |difference| relative to the plain run's
# mean |disparity| (phase config's limit and fault; its comment says why)
VDA_REL_TOL = CONFIG_REL_TOL


@contextmanager
def _vda_ranges():
    """record_function ranges around every forward of the VDA backbone
    (DINOv2 and the DPT head) and every AAPC, for the profile."""
    import torch

    from ppmstereo_tpu_torch.models import stereoanyvideo
    from ppmstereo_tpu_torch.nn.vda.video_depth import VideoDepthAnything

    def ranged(fn, label):
        def call(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call

    with _patched(VideoDepthAnything, "_head", ranged(VideoDepthAnything._head, VDA_RANGE)), \
            _patched(stereoanyvideo, "aapc_correlation",
                     ranged(stereoanyvideo.aapc_correlation, AAPC_RANGE)):
        yield (VDA_RANGE, AAPC_RANGE)


def _vda_against_plain(run, clip, disp, launches_per_window: int, smi: str) -> dict:
    """PPMStereo-VDA's window (`disp`, through the kernels) held to its plain
    version: once more with every kernel call checked against its plain
    function on the same inputs (`_kernel_swaps`), then with both kernels
    swapped for their plain functions, and that run with a wrong lookup."""
    import numpy as np

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models import ppm_stereo

    calls = []
    checked, plain, fault = _kernel_swaps(calls)
    out = {}
    for label, swap in (("checked", checked), ("plain", plain), ("fault", fault)):
        saved = {k: getattr(ppm_stereo, k) for k in swap}
        try:
            for k, fn in swap.items():
                setattr(ppm_stereo, k, fn)
            pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
            d = run(clip[:, 0], clip[:, 1])[0].float().cpu().numpy()
        finally:
            for k, fn in saved.items():
                setattr(ppm_stereo, k, fn)
        out[label] = (d, pa.play_attention.launches, kl.corr_lookup_kernel.launches)
    plays = [c for c in calls if c[0] == "play"]
    lookups = [c for c in calls if c[0] == "lookup"]
    worst = (max(c[1] for c in plays), max(c[2] for c in plays))
    lookups_equal = all(c[1] == 0.0 for c in lookups)
    p_disp = out["plain"][0]
    scale = float(np.abs(p_disp).mean())
    diff = np.abs(disp - p_disp)
    rel = float(diff.mean()) / scale
    fault_rel = float(np.abs(out["fault"][0] - p_disp).mean()) / scale
    res = dict(play_calls=len(plays), play_calls_worst_share=worst,
               lookup_calls=len(lookups), lookup_calls_bit_equal=lookups_equal,
               max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
               mean_abs_disp=scale, rel_diff=rel, fault_rel_diff=fault_rel,
               plain_launches=out["plain"][1:])
    log(f"  against its plain version on {smi}: {len(plays)} kernel 1 calls at worst "
        f"{worst[0]:.2f} / {worst[1]:.2f} of the max / mean limits, {len(lookups)} kernel 6 "
        f"calls bit-equal {lookups_equal}; the window through the plain functions: max |diff| "
        f"{diff.max():.3e} px, mean {diff.mean():.3e} px = {rel:.2e} of the mean |disparity| "
        f"{scale:.4f} px (limit {VDA_REL_TOL}); a wrong lookup: {fault_rel:.2e}")
    if (len(plays), len(lookups)) != (launches_per_window,) * 2 or not (
            worst[0] <= 1 and worst[1] <= 1 and lookups_equal):
        raise RuntimeError(f"PPMStereo-VDA: kernel 1 at worst {worst} of its limits over "
                           f"{len(plays)} calls, kernel 6 bit-equal {lookups_equal} over "
                           f"{len(lookups)}")
    if out["plain"][1:] != (0, 0) or not rel <= VDA_REL_TOL:
        raise RuntimeError(f"PPMStereo-VDA: the kernels' window differs from the plain "
                           f"functions' by {rel:.2e} of the mean |disparity| (plain run's "
                           f"launches {out['plain'][1:]})")
    if not fault_rel > VDA_REL_TOL:
        raise RuntimeError(f"PPMStereo-VDA: a wrong lookup moves the window by {fault_rel:.2e} "
                           "of the mean |disparity| only; the limit cannot catch it")
    return res


def phase_vda(main_run: dict, smi: str):
    """Each of VDA_MODELS through `model_zoo` at its shipped dtype and
    iterations: one strict window of the main clip's frames 5-14 at VDA_HW,
    the first call timed apart, then VDA_STEADY_CALLS calls (median seconds,
    peak memory, kernels 1 and 6 launched as VDA_MODELS says in each) and a
    profiled call (device busy share, the backbone's and AAPC's shares of
    device time). PPMStereo-VDA (its play blends set to 1, so that the play reaches the
    output) is held to its plain version (`_vda_against_plain`) and to its
    plain-lookup twin bit for bit; StereoAnyVideo's card f32 path to the
    CPU path on the small clip (`_zoo_small_parity`)."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    runs = {}
    for name, iters, launches_per_window in VDA_MODELS:
        h, w = VDA_HW[name]
        clip = torch.from_numpy(main_run["video"][5:5 + ZOO_FRAMES, :, :h, :w]).cuda()
        rec = {}
        if name == "StereoAnyVideoModel":
            rec["small"] = _zoo_small_parity(name, iters, None, smi)
        pred = model_zoo(name, kernel_size=WINDOW, iters=iters, seed=ZOO_SEED)
        if name == "PPMStereoVDAModel":
            _play_blends_on(pred.model, ZOO_SEED)
        dtype = str(pred.model.dtype).removeprefix("torch.")
        run = pred.predictor._run_window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(clip[:, 0], clip[:, 1])  # cuDNN's algorithm search (f32), allocations
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        steady, counts = [], []
        for _ in range(VDA_STEADY_CALLS):
            pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
            t0 = time.perf_counter()
            disp = run(clip[:, 0], clip[:, 1])[0]
            torch.cuda.synchronize()
            steady.append(time.perf_counter() - t0)
            counts.append((pa.play_attention.launches, kl.corr_lookup_kernel.launches))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        disp = disp.float().cpu().numpy()
        if disp.shape != (ZOO_FRAMES, h, w, 1) or not np.isfinite(disp).all():
            raise RuntimeError(f"vda {name}: disparity of shape {disp.shape} or not finite")
        if any(c != (launches_per_window,) * 2 for c in counts):
            raise RuntimeError(f"vda {name}: kernels 1 and 6 launched {counts} times in its "
                               f"windows, expected {launches_per_window} each")
        window_s = float(np.median(steady))
        with _vda_ranges() as ranges:
            prof = profile_window(run, clip, f"{ZOO_FRAMES}-frame {name}", smi, warm=False,
                                  ranges=ranges)
        busy = backbone = aapc = None
        if prof is not None:
            busy = prof["device_ms"] / prof["wall_ms"]
            backbone = prof["ranges"][VDA_RANGE] / prof["device_ms"]
            aapc = prof["ranges"][AAPC_RANGE] / prof["device_ms"]
        rec.update(hw=(h, w), dtype=dtype, iters=iters, first_s=first_s, steady_s=steady,
                   window_s=window_s, peak_gb=peak_gb, play_launches=counts[0][0],
                   lookup_launches=counts[0][1], busy_share=busy, backbone_share=backbone,
                   aapc_share=aapc, mean_abs_disp=float(np.abs(disp).mean()), profile=prof)

        def share(x):
            return "not measured" if x is None else f"{100 * x:.1f}%"

        log(f"vda {name} at {h}x{w}, a strict window of {ZOO_FRAMES} frames, {iters} "
            f"iterations, {dtype}, seeded weights, on {smi}: the first call {first_s:.3f} s, "
            f"then {[round(x, 3) for x in steady]} s (median {window_s:.3f} s), peak "
            f"{peak_gb:.2f} GB, kernel 1 and 6 launches a window {counts[0]}, device busy "
            f"{share(busy)}, of device time the backbone {share(backbone)} and AAPC "
            f"{share(aapc)}, mean |disparity| {rec['mean_abs_disp']:.4f} px")
        if name == "PPMStereoVDAModel":
            rec["against_plain"] = _vda_against_plain(run, clip, disp, launches_per_window, smi)
            rec["plain_lookup"] = _window_with_plain_lookup(
                pred, main_run["video"][:, :, :h, :w], smi, launches_per_window)
        runs[name] = rec
        del pred
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------------ eval
# the Dynamic Replica 40-frame protocol (ppmstereo_tpu_torch/configs/
# eval_dynamic_replica_40_frames.yaml: 40 frames, window 20, 20 iterations)
# at Dynamic Replica's 720x1280, through the evaluate CLI's run_eval with the
# anchor in bf16, on a Dynamic Replica tree made from a synthetic clip
EVAL_PRESET = REPO / "ppmstereo_tpu_torch" / "configs" / "eval_dynamic_replica_40_frames.yaml"
EVAL_FRAMES, EVAL_HEIGHT, EVAL_WIDTH = 40, 720, 1280
EVAL_WINDOW, EVAL_ITERS = 20, 20
EVAL_LAUNCHES_PER_WINDOW = EVAL_ITERS // 2 + EVAL_ITERS // 2 + EVAL_ITERS
EVAL_EPE_BOUND_PX = 1.0
# focal length (NDC, 'ndc_norm_image_bounds') and baseline of the tree's
# cameras: depth2disp scale = 1.4 * 1280 / 2 * 0.1 = 89.6 (depth 1.9-22 m)
EVAL_FOCAL_NDC, EVAL_BASELINE = 1.4, 0.1
# the reader's disparity is depth2disp / depth with depth stored as float16:
# 2^-11 relative, and one f32 rounding of the quotient
F16_DISP_RTOL = 2.0**-11 + 2.0**-22
# kernel 1 at the 720p 1/4 stage (window 20 padded to 736 x 1280): B.T 40 as
# batch_windows=2 would give it (k and v 3.0 GB each, past 2^31 bytes), held
# against its plain version on the first and the last row
EVAL_PLAY_SHAPE = (2 * EVAL_WINDOW, 184 * 320, 5 * 184 * 320)
# kernel 6 at the 720p 1/4 pyramid: (B.T, H/4, W/4, W/4)
EVAL_LOOKUP_SHAPE = (EVAL_WINDOW, 184, 320, 320)


def write_dynamic_replica_tree(root: Path, video, disparity, split_name: str = "valid",
                               subdir: str = ""):
    """`<root>/dynamic_replica_data/<subdir>/<split_name>`:
    frame_annotations_<split_name>.jgz, the clip's left and right frames as
    PNGs and the left camera's float16 depth PNGs (depth = depth2disp scale
    / disparity); the right camera's depth entries name the left's files
    (the reader reads the left's only). Returns the depth2disp scale."""
    import gzip

    import numpy as np

    from ppmstereo_tpu_torch.data.png import write_png

    split = root / "dynamic_replica_data" / subdir / split_name
    (split / "seq").mkdir(parents=True, exist_ok=True)
    height, width = video.shape[2:4]
    scale = EVAL_FOCAL_NDC * width / 2 * EVAL_BASELINE
    annots = []
    for cam_i, cam in enumerate(("left", "right")):
        for i in range(len(video)):
            img_rel, depth_rel = f"seq/{cam}_{i:04d}.png", f"seq/depth_{i:04d}.png"
            write_png(str(split / img_rel), video[i, cam_i].astype(np.uint8), level=1)
            if cam == "left":
                depth = (scale / disparity[i]).astype(np.float16)
                write_png(str(split / depth_rel), depth.view(np.uint16), level=1)
            annots.append({"sequence_name": "seq", "camera_name": cam,
                           "image": {"path": img_rel, "size": [height, width]},
                           "depth": {"path": depth_rel},
                           "viewpoint": {"focal_length": [EVAL_FOCAL_NDC, EVAL_FOCAL_NDC],
                                         "principal_point": [0.0, 0.0],
                                         "intrinsics_format": "ndc_norm_image_bounds",
                                         "T": [0.0 if cam == "left" else EVAL_BASELINE, 0, 0]}})
    with gzip.open(split / f"frame_annotations_{split_name}.jgz", "wt", encoding="utf8") as f:
        json.dump(annots, f)
    return scale


def _play_720p(smi: str) -> dict:
    """Kernel 1 at EVAL_PLAY_SHAPE: rows 0 and B.T - 1 against the plain
    version (chunked) with phase kernels' limits and fault; times at B.T 40
    and at the eval's 20, and SDPA's forward at the eval's 20."""
    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa

    b, lq, lk = EVAL_PLAY_SHAPE
    scale = pa.play_scale(128)
    gen = torch.Generator(device="cuda").manual_seed(7)
    F = torch.nn.functional
    q = (2 * torch.randn(b, lq, 128, generator=gen, device="cuda")).bfloat16()
    k = (2 * torch.randn(b, lk, 128, generator=gen, device="cuda")).bfloat16()
    v = torch.randn(b, lk, 128, generator=gen, device="cuda").bfloat16()
    got = pa.play_attention(q, k, v, scale)
    rows = torch.tensor([0, b - 1], device="cuda")
    qr, kr, vr = q[rows], k[rows], v[rows]
    ref = pa.play_attention_plain(qr, kr, vr, scale)
    fault = pa.play_attention_plain(qr, kr, vr, 2 * scale)
    o_tol = 2**-7 * ref.float().abs().max().item() + 2**-8 * vr.float().abs().max().item()
    o_mean_tol = 2**-8 * ref.float().abs().mean().item()
    label = f"720p 1/4 B.T={b} rows 0 and {b - 1}"
    check = _agreement(label, "play_attention_fwd", got[rows], ref, fault, o_tol, o_mean_tol)
    del ref, fault, qr, kr, vr
    times = {}
    for n in (b, b // 2):
        ms = cuda_time_ms(lambda: pa.play_attention(q[:n], k[:n], v[:n], scale), 3)
        flops, nbytes = pa.play_attention_cost(n, lq, lk)
        bound, by = _bound(flops, nbytes)
        times[n] = dict(ms=ms, tflops=flops / ms / 1e9, bound_ms=bound, bound_by=by)
        log(f"play_attention_fwd at the 720p 1/4 shape B.T={n} Lq={lq} Lk={lk} on {smi}: "
            f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bound {bound:.3f} ms ({by})")
    # the library call at the eval's B.T 20, with the kernel's warm-up and repeats
    n = b // 2
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q[:n, None], k[:n, None], v[:n, None], scale=scale), 3)
    times[n]["library_ms"] = lib_ms
    log(f"SDPA forward at the 720p 1/4 shape B.T={n} on {smi}: {lib_ms:.3f} ms "
        f"({pa.play_attention_cost(n, lq, lk)[0] / lib_ms / 1e9:.1f} TFLOP/s); kernel 1 "
        f"{times[n]['ms']:.3f} ms")
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(shape=label, checks={"o": check}, times=times)


def _lookup_720p(smi: str) -> dict:
    """Kernel 6 at EVAL_LOOKUP_SHAPE in bf16 (the model's), against the
    plain lookup bit for bit and within phase lookup's limits; its time and
    the four grid_samples'."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup

    n, h, w1, w2 = EVAL_LOOKUP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(8)
    f1 = torch.randn(n * h, 1, w1, 64, generator=gen, device="cuda")
    f2 = torch.randn(n * h, 1, w2, 64, generator=gen, device="cuda")
    pyramid = [c.reshape(n, h, w1, -1).to(torch.bfloat16) for c in build_corr_pyramid(f1, f2, 4)]
    del f1, f2
    cols = torch.arange(w1, device="cuda", dtype=torch.float32)
    coords = cols - torch.rand(n, h, w1, generator=gen, device="cuda") * 0.4 * w2
    got = kl.corr_lookup_kernel(pyramid, coords, out_dtype=torch.bfloat16)
    want = corr_lookup(pyramid, coords).to(torch.bfloat16)
    fault = _lookup_fault(pyramid, coords).to(torch.bfloat16)
    label = f"720p 1/4 N={n} H={h} W1={w1} W2={w2} bfloat16 -> bfloat16"
    check = _agreement(label, "corr_lookup", got, want, fault,
                       2**-21 * want.float().abs().max().item(),
                       2**-23 * want.float().abs().mean().item())
    check["bit_equal"] = bool(torch.equal(got, want))
    if not check["bit_equal"]:
        raise RuntimeError(f"corr_lookup at {label} is not bit-equal to the plain lookup")

    def kernel():
        return kl.corr_lookup_kernel(pyramid, coords, out_dtype=torch.bfloat16)

    def us(x):
        return "not measured" if x is None else f"{x * 1e3:.1f} us"

    ms = cuda_time_ms(kernel, 20)
    # the library route with the kernel's warm-up and repeats: four
    # grid_samples on the pyramid widened to f32 (see phase lookup)
    wide, grids = [c.float() for c in pyramid], []
    for lvl, corr in enumerate(pyramid):
        pos = (coords / 2.0**lvl).reshape(-1, 1, 1) + torch.arange(-4, 5, device="cuda")
        gx = 2.0 * pos / (corr.shape[-1] - 1) - 1.0
        grids.append(torch.stack([gx, torch.zeros_like(gx)], dim=-1))
    lib_ms = cuda_time_ms(lambda: _grid_sample_lookup(wide, grids), 20)
    del wide, grids
    device_ms = _device_ms(kernel, "corr_lookup", 10)
    # on the main path the pyramid is read once an iteration, between other
    # work: the flushed figure is the one a window sees
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, five times the L2
    cold_ms = _device_ms(kernel, "corr_lookup", 10, flush=flush)
    nbytes = kl.corr_lookup_bytes(pyramid, coords, out_dtype=torch.bfloat16)
    bound, by = _bound(0.0, nbytes)
    rate = None if cold_ms is None else nbytes / cold_ms / 1e6
    log(f"corr_lookup at {label} on {smi}: {ms * 1e3:.1f} us per call, device time "
        f"{us(device_ms)} with the L2 warm, {us(cold_ms)} flushed ({rate} GB/s of the "
        f"{nbytes / 1e6:.1f} MB it must move), bound {bound * 1e3:.2f} us ({by}); 4 x "
        f"grid_sample {lib_ms * 1e3:.1f} us per call; bit-equal {check['bit_equal']}")
    del pyramid, coords, got, want, fault, flush
    torch.cuda.empty_cache()
    return dict(shape=label, checks={"out": check}, ms=ms, device_ms=device_ms,
                device_cold_ms=cold_ms, gb_per_s=rate, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def phase_eval(smi: str):
    """The Dynamic Replica 40-frame protocol at 720x1280 through the
    evaluate CLI's run_eval: aggregate EPE/TEPE/bad-px and fps, seconds and
    kernel 1 and 6 launches per window, peak memory, the reader's host
    seconds; the reader's disparity against the clip's, run_eval's disparity
    against a direct call of the same predictor, EPE under its bound; one
    steady 20-frame window profiled; kernels 1 and 6 at the 720p shapes
    against their plain versions."""
    import tempfile

    import numpy as np
    import torch

    from ppmstereo_tpu_torch.cli import evaluate as cli
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.utils.config import load_yaml

    kernels = dict(play=_play_720p(smi), lookup=_lookup_720p(smi))
    t0 = time.perf_counter()
    video, gt = synthetic_clip(EVAL_FRAMES, EVAL_HEIGHT, EVAL_WIDTH, seed=3)
    clip_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_dynamic_replica_tree(Path(tmp), video, gt)
        write_s = time.perf_counter() - t0
        cfg = load_yaml(cli.DefaultConfig, str(EVAL_PRESET), overrides=[
            f"dataset_root={tmp}", f"exp_dir={tmp}/out", f"MODEL.checkpoint={ANCHOR}"])
        if (cfg.sample_len, cfg.MODEL.kernel_size, cfg.MODEL.iters) != (
                EVAL_FRAMES, EVAL_WINDOW, EVAL_ITERS):
            raise RuntimeError(f"the preset is not the 40-frame protocol: {cfg}")
        t0 = time.perf_counter()
        sample = cli.build_dataset(cfg)[0]
        reader_s = time.perf_counter() - t0
        read_disp = -sample["disp"][:, 0, :, :, 0]
        reader_err = float(np.abs(read_disp - gt).max())
        rel_err = float((np.abs(read_disp - gt) / gt).max())
        log(f"eval tree: clip {clip_s:.1f} s, PNG writes {write_s:.1f} s; the reader took "
            f"{reader_s:.2f} s of host time for {EVAL_FRAMES} frame pairs and depth maps; its "
            f"disparity within {rel_err:.3e} relative ({reader_err:.3e} px) of the clip's "
            f"(float16 depth: limit {F16_DISP_RTOL:.3e})")
        if sample["img"].shape != (EVAL_FRAMES, 2, EVAL_HEIGHT, EVAL_WIDTH, 3) \
                or not rel_err <= F16_DISP_RTOL or sample["valid"].min() != 1.0:
            raise RuntimeError("the Dynamic Replica reader does not give the clip back")
        if not np.array_equal(sample["img"], video):
            raise RuntimeError("the Dynamic Replica reader's frames differ from the clip's")

        # run_eval, with the zoo's predictor captured for the direct call
        captured = {}
        zoo = cli.model_zoo

        def capturing_zoo(*args, **kwargs):
            pred = zoo(*args, **kwargs)
            captured.update(pred=pred, records=timed_windows(pred))

            def recorded(batch):
                out = pred(batch)
                captured["disparity"] = out["disparity"]
                return out

            return _Recorded(pred, recorded)

        cli.model_zoo = capturing_zoo
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.play_attention.launches = kl.corr_lookup_kernel.launches = 0
        try:
            t0 = time.perf_counter()
            results = cli.run_eval(cfg)
            eval_s = time.perf_counter() - t0
        finally:
            cli.model_zoo = zoo
        play, lookup = pa.play_attention.launches, kl.corr_lookup_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dumped = json.loads((Path(tmp) / "out" / "result_dynamicreplica_final.json").read_text())
    agg = results["aggregate"]
    records = captured["records"]
    window_s = [r["s"] for r in records]
    log(f"eval (Dynamic Replica, {EVAL_FRAMES} frames at {EVAL_HEIGHT}x{EVAL_WIDTH}, window "
        f"{EVAL_WINDOW}, {EVAL_ITERS} iterations, bf16) on {smi}: run_eval {eval_s:.1f} s; EPE {agg['epe_mean']:.4f} px, "
        f"TEPE {agg['temp_epe_mean']:.4f} px, bad-0.5/1/2/3px {agg['epe_bad_0.5px']:.3f} / "
        f"{agg['epe_bad_1px']:.3f} / {agg['epe_bad_2px']:.3f} / {agg['epe_bad_3px']:.3f} %, "
        f"fps {agg['fps']:.3f}; seconds per window {[round(s, 3) for s in window_s]}; "
        f"kernel 1 launches {play} ({[r['play'] for r in records]}), kernel 6 launches "
        f"{lookup}; peak {peak_gb:.2f} GB")
    stride = EVAL_WINDOW // 2
    frames = window_frames(EVAL_FRAMES, EVAL_WINDOW)  # 20, 20, 20, 10
    want = [EVAL_LAUNCHES_PER_WINDOW] * len(frames)
    if [r["play"] for r in records] != want or [r["lookup"] for r in records] != want \
            or [r["frames"] for r in records] != frames:
        raise RuntimeError(f"eval windows {[(r['frames'], r['play'], r['lookup']) for r in records]}"
                           f", expected {frames} frames, {want[0]} launches each")
    if dumped != json.loads(json.dumps(results)):
        raise RuntimeError("run_eval's JSON dump differs from its results")
    if not agg["epe_mean"] <= EVAL_EPE_BOUND_PX:
        raise RuntimeError(f"eval EPE {agg['epe_mean']:.3f} px exceeds {EVAL_EPE_BOUND_PX} px")

    # the same predictor called directly on the same video: bit for bit
    pred, eval_disp = captured["pred"], captured["disparity"]
    n_before = len(records)
    t0 = time.perf_counter()
    direct = pred({"stereo_video": video})["disparity"]
    direct_s = time.perf_counter() - t0
    equal = bool(np.array_equal(direct, eval_disp))
    log(f"a direct call of the same predictor: {direct_s:.1f} s, seconds per window "
        f"{[round(r['s'], 3) for r in records[n_before:]]}, disparity bit-equal to "
        f"run_eval's {equal}")
    if not equal:
        raise RuntimeError("run_eval's disparity differs from a direct call of its predictor")
    direct_window_s = [r["s"] for r in records[n_before:]]
    metrics = sequence_metrics(direct, gt)
    profile = profile_window(pred.predictor._run_window,
                             torch.from_numpy(video[stride:stride + EVAL_WINDOW]).cuda(),
                             f"{EVAL_WINDOW}-frame 720p", smi, warm=False)
    del pred, captured
    torch.cuda.empty_cache()
    return dict(aggregate=agg, window_s=window_s, direct_window_s=direct_window_s,
                play_launches=play, lookup_launches=lookup, peak_gb=peak_gb, reader_s=reader_s,
                write_s=write_s, eval_s=eval_s, reader_rel_err=rel_err, bit_equal=equal,
                direct_epe=metrics["epe_mean"], profile=profile, kernels=kernels)


class _Recorded:
    """A predictor whose calls go through `call` and whose other attributes
    (load_params, ...) are the wrapped one's."""

    def __init__(self, inner, call):
        self.inner, self._call = inner, call

    def __call__(self, batch):
        return self._call(batch)

    def __getattr__(self, name):
        return getattr(self.inner, name)


TRAIN_DIR = REPO / "build" / "chip_smoke_train"
DI_RANGE = "play_attention_di"  # the profiler range around Di in play_attention_bwd
# kernel-name fragments of a train step's device time
_TRAIN_GROUPS = (
    ("play forward with residual (kernel 2)", ("play_attention_fwd_kernel",)),
    ("play dq (kernel 3)", ("play_attention_bwd_dq_kernel",)),
    ("play dk/dv (kernel 4)", ("play_attention_bwd_dkv_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop",
                              "dgrad", "wgrad")),
)


def _launch_counts():
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa

    return {"corr_lookup": kl.corr_lookup_kernel.launches,
            "play_attention_fwd": pa.play_attention.launches,
            "play_attention_fwd_res": pa.play_attention_fwd_res.launches,
            "play_attention_bwd_dq": pa.play_attention_bwd_dq.launches,
            "play_attention_bwd_dkv": pa.play_attention_bwd_dkv.launches}


def phase_train(smi: str):
    """`train()` at the shipped TrainConfig() on the card from the anchor:
    TRAIN_FIXED_STEPS steps on one batch of the synthetic fallback, then
    TRAIN_FRESH_STEPS on fresh batches."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.train.state import param_label
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, train
    from ppmstereo_tpu_torch.utils.weights import flax_to_state_dict, load_npz

    cfg = TrainConfig(exp_dir=str(TRAIN_DIR), log_freq=1)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    flat = load_npz(ANCHOR)
    start = flax_to_state_dict(flat)
    data = iter(fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                 batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                 seed=cfg.seed))
    fixed = next(data)
    batches = [fixed] * TRAIN_FIXED_STEPS + [next(data) for _ in range(TRAIN_FRESH_STEPS)]
    n_steps = len(batches)
    marks = []  # launch counts as each step begins (the previous one has
    # ended: the trainer reads every step's metrics with log_freq=1)

    def loader():
        for batch in batches:
            marks.append(_launch_counts())
            yield batch

    for fn in (pa.play_attention, pa.play_attention_fwd_res, pa.play_attention_bwd_dq,
               pa.play_attention_bwd_dkv, kl.corr_lookup_kernel):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, loader=loader(), max_steps=n_steps, init_params=flat, device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    marks.append(_launch_counts())
    launches = marks[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    records = [json.loads(line) for line in (TRAIN_DIR / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in records]
    step_s = [1.0 / r["steps_per_s"] for r in records]
    per_step = [{k: marks[i + 1][k] - marks[i][k] for k in launches} for i in range(n_steps)]
    log(f"train {n_steps} steps at {cfg.crop_size[0]}x{cfg.crop_size[1]}, {cfg.sample_len} frames, "
        f"batch {cfg.batch_size}, {cfg.train_iters} iterations, "
        f"{'bf16' if cfg.mixed_precision else 'f32'}, on {smi}: losses "
        f"{[round(x, 4) for x in losses]}, seconds per step {[round(x, 3) for x in step_s]} "
        f"(first {step_s[0]:.3f}; after it mean {sum(step_s[1:]) / (n_steps - 1):.3f}), "
        f"peak memory {peak_gb:.2f} GB, {total_s:.1f} s in train(); launches per step {per_step[0]}")
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"train losses {losses}: not one finite loss per step")
    if not losses[TRAIN_FIXED_STEPS - 1] < losses[0]:
        raise RuntimeError(f"the fixed batch's loss did not fall: {losses[:TRAIN_FIXED_STEPS]}")
    if any(step != TRAIN_LAUNCHES_PER_STEP for step in per_step):
        raise RuntimeError(f"kernel launches per step {per_step}, expected {TRAIN_LAUNCHES_PER_STEP}")
    # every trainable tensor must move but those whose gradient is ~0 (a
    # bias ahead of an instance norm moves by less than an f32 ulp), read
    # by the significance rule of the small parity on the fixed batch
    live = significant(_grad_max(state, fixed))
    moved, frozen_moved, still, exempt = 0, [], [], []
    for name, p in state.model.named_parameters():
        changed = not torch.equal(p.detach().cpu(), start[name])
        if param_label(name) == "frozen":
            frozen_moved += [name] if changed else []
        elif changed:
            moved += 1
        else:
            (still if name in live else exempt).append(name)
    log(f"train: {moved} trainable tensors moved; {len(exempt)} with a gradient below "
        f"{SIGNIFICANT_GRAD} of the largest did not {exempt}; {len(still)} others did not "
        f"{still}; {len(frozen_moved)} frozen ConvNeXt tensors moved")
    if frozen_moved or still:
        raise RuntimeError("trainable parameters that did not move, or frozen ones that did")
    profile = _profile_train_step(state, fixed, smi)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return dict(launches=launches, per_step=per_step, losses=losses, step_s=step_s,
                peak_gb=peak_gb, profile=profile)


# the reference recipe (phase train, second part): the train CLI with a YAML
# preset on the SceneFlow + Dynamic Replica mixture, written from synthetic
# clips at the crop plus a margin (the augmentor's smallest scale needs 8
# pixels more than the crop); then train() with the in-training evaluation
# and a save callback
RECIPE_STEPS = 4
RECIPE_SCENEFLOW_FRAMES, RECIPE_DR_FRAMES = 8, 20
RECIPE_PRESET = """# the shipped TrainConfig, written out, for a short run
model_name: ppmstereo
batch_size: 2
lr: 0.0003
sample_len: 5
train_iters: 10
mixed_precision: true
num_workers: 4
seed: 0
log_freq: 1
model_kwargs:
  hidden_dim: 128
  context_dim: 128
  dim: 256
  attention_type: self_stereo_temporal_update_time_update_space
  sst_depth: 4
  use_cnet: true
  use_convex_3d: true
  top_k: 5
  corr_levels: 4
  corr_radius: 4
"""
# the in-training evaluation: two 4-frame synthetic clips at the crop, one
# window each (kernel size 10), 10 iterations; and a third window for the
# image dump where the logger has a TensorBoard writer
RECIPE_EVAL_LAUNCHES = 2 * LAUNCHES_PER_WINDOW


def write_sceneflow_tree(root: Path, video, disparity):
    """`<root>/SceneFlow/Monkaa/frames_finalpass/scene`: the clip's frames as
    PNGs and the left and right disparity as PFMs (Monkaa: the reader keeps
    every sequence of it for training, while FlyingThings3D's TRAIN split
    gives its first 40 sequences to the test split)."""
    import numpy as np

    from ppmstereo_tpu_torch.data.frame_utils import write_pfm
    from ppmstereo_tpu_torch.data.png import write_png

    seq = root / "SceneFlow" / "Monkaa" / "frames_finalpass" / "scene"
    for cam_i, cam in enumerate(("left", "right")):
        (seq / cam).mkdir(parents=True, exist_ok=True)
        disp_dir = Path(str(seq / cam).replace("frames_finalpass", "disparity"))
        disp_dir.mkdir(parents=True, exist_ok=True)
        for i in range(len(video)):
            write_png(str(seq / cam / f"{i:04d}.png"), video[i, cam_i].astype(np.uint8), level=1)
            write_pfm(str(disp_dir / f"{i:04d}.pfm"), disparity[i].astype(np.float32))


def phase_train_recipe(smi: str):
    """The train CLI with --config (RECIPE_PRESET) on the mixture of a
    SceneFlow and a Dynamic Replica train tree written here: the loader
    built from both roots, batches drawn from both, RECIPE_STEPS finite
    losses; then train(enable_eval=True, save_callback=...) for 2 steps with
    a save and an evaluation at step 2: the callback given the port's state,
    the evaluation launching kernels 1 and 6 on the card."""
    import os
    import tempfile

    import numpy as np
    import torch

    from ppmstereo_tpu_torch.cli import train as train_cli
    from ppmstereo_tpu_torch.data import datasets
    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.train import trainer
    from ppmstereo_tpu_torch.train.state import TrainState

    cfg0 = trainer.TrainConfig()
    h, w = cfg0.crop_size[0] + 32, cfg0.crop_size[1] + 64
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        video, gt = synthetic_clip(RECIPE_SCENEFLOW_FRAMES, h, w, seed=5)
        write_sceneflow_tree(tmp / "datasets", video, gt)
        video, gt = synthetic_clip(RECIPE_DR_FRAMES, h, w, seed=6)
        write_dynamic_replica_tree(tmp / "datasets", video, gt, split_name="train")
        write_s = time.perf_counter() - t0
        preset = tmp / "preset.yaml"
        preset.write_text(RECIPE_PRESET)

        fetch = datasets.fetch_dataloader
        loaders, served = [], []

        def recording_fetch(*args, **kwargs):
            loader = fetch(*args, **kwargs)
            for part, d in enumerate(loader.dataset.datasets):
                getitem = d.__getitem__

                def tapped(index, rng=None, _get=getitem, _part=part):
                    served.append(_part)
                    return _get(index, rng)

                d.__getitem__ = tapped
            loaders.append(loader)
            return loader

        cwd = os.getcwd()
        datasets.fetch_dataloader = recording_fetch
        try:
            os.chdir(tmp)  # the loader's default roots: datasets/SceneFlow, ...
            t0 = time.perf_counter()
            state = train_cli.main(["--config", str(preset), f"num_steps={RECIPE_STEPS}",
                                    f"exp_dir={tmp / 'cli'}"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            datasets.fetch_dataloader = fetch
        (loader,) = loaders
        parts = [type(d).__name__ for d in loader.dataset.datasets]
        sizes = [len(d) for d in loader.dataset.datasets]
        records = [json.loads(x) for x in (tmp / "cli" / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in records]
        drawn = sorted(set(served))
        log(f"train CLI --config on the mixture on {smi}: trees written in {write_s:.1f} s; "
            f"parts {parts} of {sizes} samples (x50), samples drawn from parts {drawn} "
            f"({len(served)} samples); {RECIPE_STEPS} steps, losses "
            f"{[round(x, 4) for x in losses]}, seconds per step "
            f"{[round(1 / r['steps_per_s'], 3) for r in records]}; {cli_s:.1f} s in main()")
        if parts != ["SequenceSceneFlowDataset", "DynamicReplicaDataset"] or min(sizes) == 0:
            raise RuntimeError(f"the mixture has parts {parts} of {sizes} samples")
        if drawn != [0, 1]:
            raise RuntimeError(f"the batches came from parts {drawn} only")
        if state.step != RECIPE_STEPS or len(losses) != RECIPE_STEPS \
                or not all(np.isfinite(losses)):
            raise RuntimeError(f"train CLI: step {state.step}, losses {losses}")
        out.update(cli_s=cli_s, cli_losses=losses, parts=parts, part_sizes=sizes,
                   samples_from=drawn, write_s=write_s)
        del state

        cfg = trainer.TrainConfig(exp_dir=str(tmp / "direct"), ckpt_after_steps=0,
                                  save_freq=2, eval_freq=2, log_freq=1)
        saves, evals = [], []
        run_eval = trainer.run_in_training_eval

        def counted_eval(cfg_, params, step, logger, *args, **kwargs):
            torch.cuda.synchronize()
            before = pa.play_attention.launches, kl.corr_lookup_kernel.launches
            results = run_eval(cfg_, params, step, logger, *args, **kwargs)
            # with a TensorBoard writer, one more window for the image dump
            want = RECIPE_EVAL_LAUNCHES + LAUNCHES_PER_WINDOW * (logger.writer is not None)
            evals.append((pa.play_attention.launches - before[0],
                          kl.corr_lookup_kernel.launches - before[1], want))
            return results

        def callback(step, st):
            saves.append((step, st, (Path(cfg.exp_dir) / "ckpt" / f"step_{step}.pt").is_file()))

        trainer.run_in_training_eval = counted_eval
        try:
            t0 = time.perf_counter()
            state = trainer.train(cfg, max_steps=2, enable_eval=True, save_callback=callback,
                                  device="cuda")
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t0
        finally:
            trainer.run_in_training_eval = run_eval
        records = [json.loads(x) for x in
                   (tmp / "direct" / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in records if "loss" in r]
        dumped = json.loads((tmp / "direct" / "result_intrain_2.json").read_text())
        log(f"train(enable_eval=True, save_callback=...) on {smi}: {direct_s:.1f} s; saves "
            f"{[(step, ok) for step, _, ok in saves]}; evaluations at step 2: kernel 1 and 6 "
            f"launches and the expected {evals}, EPE "
            f"{dumped['aggregate']['epe_mean']:.3f} px (untrained); losses {losses}")
        if [(step, ok, st is state and isinstance(st, TrainState)) for step, st, ok in saves] \
                != [(2, True, True)]:
            raise RuntimeError(f"save_callback calls {[(s_, ok) for s_, _, ok in saves]}")
        if len(evals) != 1 or not evals[0][0] == evals[0][1] == evals[0][2]:
            raise RuntimeError(f"in-training evaluation launches {evals}, expected one "
                               "evaluation of two clips (and the image dump where the logger "
                               "has a writer), 20 each a window")
        if len(losses) != 2 or not all(np.isfinite(losses)) \
                or not np.isfinite(dumped["aggregate"]["epe_mean"]):
            raise RuntimeError(f"losses {losses}, eval {dumped['aggregate']}")
        out.update(direct_s=direct_s, direct_losses=losses, saves=[s_ for s_, _, _ in saves],
                   eval_launches=evals,
                   eval_epe=dumped["aggregate"]["epe_mean"])
        del state
    torch.cuda.empty_cache()
    return out


# training the rest of the zoo (phase train_zoo): each model at
# TrainConfig(model_name=...), i.e. the JAX `build_train_model`'s configuration at the
# shipped recipe (320x512, 5 frames, batch 2, 10 iterations, bf16), from the
# port's seeded initialisation (no checkpoint of these models is on disk),
# ZOO_TRAIN_FIXED_STEPS steps on one batch of the synthetic fallback, then
# ZOO_TRAIN_FRESH_STEPS on fresh batches. PPMStereo-VDA's step runs the play
# attention's training kernels as PPMStereo's does; the other three launch
# no kernel of the port.
ZOO_TRAIN_MODELS = ("ppmstereo_vda", "dynamicstereo", "bidastereo", "stereoanyvideo")
ZOO_TRAIN_FIXED_STEPS, ZOO_TRAIN_FRESH_STEPS = 4, 1
ZOO_TRAIN_SEED = 3
NO_LAUNCHES = {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}
ZOO_TRAIN_LAUNCHES = {name: TRAIN_LAUNCHES_PER_STEP if name == "ppmstereo_vda" else NO_LAUNCHES
                      for name in ZOO_TRAIN_MODELS}
# each model's frozen parts (train/state.py::FROZEN_PREFIXES): bit-equal
# through the run, and none of them missing
ZOO_FROZEN = {"ppmstereo_vda": ("cnet.convnext.", "backbone."), "dynamicstereo": (),
              "bidastereo": ("raft.",), "stereoanyvideo": ("depthnet.depthanything.",)}
# the small parity's clip (frames, height, width) and iterations: the card's
# f32 step against the port's CPU path (which tests/test_torch_train_*.py
# hold against jax.value_and_grad), within phase train small parity's
# limits; and the card's bf16 step's loss against its f32 step's, the
# shipped precision against the parity's, within ZOO_TRAIN_BF16_LOSS_TOL
ZOO_TRAIN_SMALL = (2, 64, 128)
ZOO_TRAIN_SMALL_ITERS = 2
ZOO_TRAIN_BF16_LOSS_TOL = 5e-2
# the feature encoders' gradients (fnet, cnet) reach a parameter through a
# dozen stacked instance norms, whose backward cancels most of what comes
# in: at a fresh initialisation f32 rounding is amplified there (both
# packages' f32 gradients of a fresh encoder read 1.8e-3 to 1.1e-2 against
# float64: tests/test_torch_train_dynamic_stereo.py). Each model's encoders
# are held to 2.5-4 times the most the card has read against the CPU on this
# clip (NVIDIA H100 80GB HBM3: 8.0e-3 PPMStereo-VDA, 2.61e-3 DynamicStereo,
# 6.31e-4 BiDAStereo, 2.42e-3 StereoAnyVideo), below what the card reads
# with a wrong encoder norm (ZOO_TRAIN_FAULTS["norm"]: 0.180, 3.14e-2,
# 2.37e-2 and 2.08e-2); the rest to phase train small parity's limits
ZOO_ENCODERS = ("fnet.", "cnet.")
ZOO_TRAIN_ENCODER_GRAD_TOL = {"ppmstereo_vda": 2e-2, "dynamicstereo": 1e-2,
                              "bidastereo": 2.5e-3, "stereoanyvideo": 1e-2}
# the other tensors: phase train small parity's limit, but PPMStereo-VDA's,
# whose play step rounds q/k/v and their gradients to bf16 on both devices
# in other orders (the card's kernels 2-4, the CPU's plain versions):
# there, from a fresh initialisation with the play blends on, the roundings
# that flip move the gradients upstream of the play by up to 3.15e-3 on the
# card (sst, 2 frames), where PPMStereo from the anchor reads 6.5e-4; held
# to 1e-2, which the card's step with dk doubled (ZOO_TRAIN_FAULTS["dk"])
# exceeds at 1.83e-2
ZOO_TRAIN_GRAD_TOL = {name: 1e-2 if name == "ppmstereo_vda" else TRAIN_GRAD_TOL
                      for name in ZOO_TRAIN_MODELS}
# the faults each model's card step is run with, the group of gradients
# each must put beyond its limit, and the models that run it: the feature
# encoders' instance norms with the unbiased variance (torch.var's default;
# the JAX norm divides by the count), and the play attention's dk doubled
ZOO_TRAIN_FAULTS = {"norm": ("encoder", ZOO_TRAIN_MODELS), "dk": ("tensor", ("ppmstereo_vda",))}
ZOO_TRAIN_DIR = REPO / "build" / "chip_smoke_train_zoo"


def _zoo_start(cfg, blends_on: bool = False):
    """The model of `cfg` at the port's seeded initialisation on the CPU,
    and its parameters as flat flax arrays (the trainer's `init_params`).
    `blends_on`: the play blends at 1 and the time embedding drawn
    (`_play_blends_on`; at init the blends are 0, and the play's backward
    then reaches no gradient)."""
    from ppmstereo_tpu_torch.train.trainer import build_train_model
    from ppmstereo_tpu_torch.utils.init import init_model
    from ppmstereo_tpu_torch.utils.weights import model_to_flax

    model, _ = build_train_model(cfg)
    init_model(model, ZOO_TRAIN_SEED)
    if blends_on:
        _play_blends_on(model, ZOO_TRAIN_SEED)
    return model, model_to_flax(model)


def _unbiased_instance_norm(self, x):
    """InstanceNorm.forward with the unbiased variance: a wrong norm."""
    import torch

    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(x.dim() - 3, x.dim() - 2), keepdim=True, correction=1)
    return ((x32 - mean) / torch.sqrt(var + self.epsilon)).to(x.dtype)


def _zoo_small_step(name: str, dev: str, flat, batch: dict, mixed_precision: bool = False,
                    fault: str | None = None):
    """One train_step of `name` (ZOO_TRAIN_SMALL_ITERS iterations) from
    `flat` on `dev`: (loss, gradients, parameters after the update, the
    optimiser), the tensors on the CPU. `fault` (ZOO_TRAIN_FAULTS): "norm",
    the feature encoders' instance norms with the unbiased variance; "dk",
    the play attention's dk doubled in the backward that `dev` runs."""
    import types

    import torch

    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.nn.norm import InstanceNorm
    from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState
    from ppmstereo_tpu_torch.train.step import to_device, train_step
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, build_train_model
    from ppmstereo_tpu_torch.utils.weights import load_flax_params

    cfg = TrainConfig(model_name=name, sample_len=ZOO_TRAIN_SMALL[0],
                      train_iters=ZOO_TRAIN_SMALL_ITERS, mixed_precision=mixed_precision)
    model, has_uncertainty = build_train_model(cfg)
    load_flax_params(model, flat)
    model.to(dev)
    if fault == "norm":
        norms = [m for n, m in model.named_modules()
                 if n.startswith(ZOO_ENCODERS) and isinstance(m, InstanceNorm)]
        assert norms, name
        for m in norms:
            m.forward = types.MethodType(_unbiased_instance_norm, m)
    backward = pa.play_attention_bwd_plain if dev == "cpu" else pa.play_attention_bwd
    if fault == "dk":
        setattr(pa, backward.__name__, lambda *a: (lambda g: (g[0], 2 * g[1], g[2]))(
            backward(*a)))
    state = TrainState(model, TrainOptimizer(model, num_steps=1000), has_uncertainty)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().float().cpu().clone()))
        for n, p in model.named_parameters() if p.requires_grad]
    try:
        state, metrics = train_step(state, to_device(batch, torch.device(dev)))
        loss = float(metrics["loss"])
    finally:
        setattr(pa, backward.__name__, backward)
    params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    return loss, grads, params, state.optimizer


def _zoo_train_small(name: str, smi: str) -> dict:
    """`name`'s f32 train step on the small clip, card against CPU (loss,
    every gradient, the updated parameters), the card's bf16 step's loss
    against the card's f32 one, and the card's step with each of its
    ZOO_TRAIN_FAULTS, which must leave the limit of its group; what
    disagrees goes to `failures`."""
    import torch

    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset
    from ppmstereo_tpu_torch.train.state import onecycle_lr
    from ppmstereo_tpu_torch.train.trainer import TrainConfig

    torch.set_num_threads(8)
    frames, h, w = ZOO_TRAIN_SMALL
    sample = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w,
                                    seed=1)[0]
    batch = {"left": sample["img"][None, :, 0], "right": sample["img"][None, :, 1],
             "disparity": sample["disp"][None, :, 0], "valid": sample["valid"][None, :, 0]}
    cfg = TrainConfig(model_name=name, sample_len=frames, train_iters=ZOO_TRAIN_SMALL_ITERS,
                      mixed_precision=False)
    _, flat = _zoo_start(cfg, blends_on=name == "ppmstereo_vda")
    l_cpu, g_cpu, p_cpu, opt = _zoo_small_step(name, "cpu", flat, batch)
    l_cuda, g_cuda, p_cuda, _ = _zoo_small_step(name, "cuda", flat, batch)
    l_bf16 = _zoo_small_step(name, "cuda", flat, batch, mixed_precision=True)[0]
    faults = {fault: grad_agreement(_zoo_small_step(name, "cuda", flat, batch, fault=fault)[1],
                                    g_cpu, ZOO_ENCODERS)[group]
              for fault, (group, names) in ZOO_TRAIN_FAULTS.items() if name in names}
    limits = {"encoder": ZOO_TRAIN_ENCODER_GRAD_TOL[name], "tensor": ZOO_TRAIN_GRAD_TOL[name]}
    loss_rel = abs(l_cuda - l_cpu) / abs(l_cpu)
    bf16_rel = abs(l_bf16 - l_cuda) / abs(l_cuda)
    grad = grad_agreement(g_cuda, g_cpu, ZOO_ENCODERS)
    lr0 = onecycle_lr(0, opt.num_steps, opt.lr)
    n_total = sum(p.numel() for p in p_cpu.values())
    n_off = sum(int(((p_cuda[n] - p).abs() > lr0 / 2).sum()) for n, p in p_cpu.items())
    off_share = n_off / n_total
    log(f"train_zoo {name} small step {(1, *ZOO_TRAIN_SMALL)}, f32, {ZOO_TRAIN_SMALL_ITERS} "
        f"iterations, on {smi}: loss cpu {l_cpu:.6f} cuda {l_cuda:.6f} (rel {loss_rel:.2e}, "
        f"tol {TRAIN_LOSS_TOL}); {len(g_cpu)} gradients, norm ratio at worst "
        f"{grad['tensor'][0]:.3e} ({grad['tensor'][1]}; tol {ZOO_TRAIN_GRAD_TOL[name]}), "
        f"one-element "
        f"{grad['scalar'][0]:.3e} ({grad['scalar'][1]}; tol {TRAIN_SCALAR_GRAD_TOL}), the "
        f"feature encoders {grad['encoder'][0]:.3e} ({grad['encoder'][1]}; tol "
        f"{ZOO_TRAIN_ENCODER_GRAD_TOL[name]}); updated parameters {off_share:.2e} of {n_total} "
        f"elements off by more than lr/2 (tol {TRAIN_UPDATE_TOL}); the card's bf16 step loss "
        f"{l_bf16:.6f}, rel {bf16_rel:.2e} of the f32 one (tol {ZOO_TRAIN_BF16_LOSS_TOL}); "
        "the card's step with a fault: " + ", ".join(
            f"{fault} {reading:.3e} ({where}; the {ZOO_TRAIN_FAULTS[fault][0]} limit)"
            for fault, (reading, where) in faults.items()))
    failures = []
    if set(g_cuda) != set(g_cpu) or not (
            loss_rel <= TRAIN_LOSS_TOL and grad["tensor"][0] <= ZOO_TRAIN_GRAD_TOL[name]
            and grad["scalar"][0] <= TRAIN_SCALAR_GRAD_TOL
            and grad["encoder"][0] <= ZOO_TRAIN_ENCODER_GRAD_TOL[name]
            and off_share <= TRAIN_UPDATE_TOL):
        failures.append(f"train_zoo {name}: the card's f32 train step disagrees with the CPU "
                        "path")
    for fault, (reading, _) in faults.items():
        group = ZOO_TRAIN_FAULTS[fault][0]
        if not reading > limits[group]:
            failures.append(f"train_zoo {name}: the {group} limit {limits[group]} does not "
                            f"catch the fault {fault} (read {reading:.3e})")
    if not (math.isfinite(l_bf16) and bf16_rel <= ZOO_TRAIN_BF16_LOSS_TOL):
        failures.append(f"train_zoo {name}: the bf16 step's loss {l_bf16} is off the f32 "
                        f"step's {l_cuda}")
    return dict(loss_rel=loss_rel, grad=grad, update_off=off_share, bf16_loss_rel=bf16_rel,
                faults=faults, failures=failures)


def _zoo_train_run(name: str, batches: list, smi: str) -> dict:
    """`train()` of `name` at TrainConfig() on `batches` (the first
    ZOO_TRAIN_FIXED_STEPS the same batch) from the seeded initialisation:
    one finite loss a step, a falling loss on the fixed batch, every
    trainable tensor with a significant gradient moved, every frozen tensor
    bit-equal, the expected launches each step; then one profiled step."""
    import numpy as np
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.train.state import param_label
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, train

    exp_dir = ZOO_TRAIN_DIR / name
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = TrainConfig(model_name=name, exp_dir=str(exp_dir), log_freq=1)
    model0, flat = _zoo_start(cfg)
    start = {k: v.clone() for k, v in model0.state_dict().items()}
    del model0
    marks = []

    def loader():
        for batch in batches:
            marks.append(_launch_counts())
            yield batch

    for fn in (pa.play_attention, pa.play_attention_fwd_res, pa.play_attention_bwd_dq,
               pa.play_attention_bwd_dkv, kl.corr_lookup_kernel):
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train(cfg, loader=loader(), max_steps=len(batches), init_params=flat,
                  device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    marks.append(_launch_counts())
    launches = marks[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = len(batches)
    records = [json.loads(x) for x in (exp_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in records]
    step_s = [1.0 / r["steps_per_s"] for r in records]
    per_step = [{k: marks[i + 1][k] - marks[i][k] for k in launches} for i in range(n_steps)]
    steady_s = sum(step_s[1:]) / (n_steps - 1)
    log(f"train_zoo {name} at {cfg.crop_size[0]}x{cfg.crop_size[1]}, {cfg.sample_len} frames, "
        f"batch {cfg.batch_size}, {cfg.train_iters} iterations, bf16, on {smi}: losses "
        f"{[round(x, 4) for x in losses]}, seconds per step {[round(x, 3) for x in step_s]} "
        f"(first {step_s[0]:.3f}; after it mean {steady_s:.3f}), peak memory {peak_gb:.2f} "
        f"GB, {total_s:.1f} s in train(); launches per step {per_step[0]}")
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"train_zoo {name}: losses {losses}, not one finite loss a step")
    if not losses[ZOO_TRAIN_FIXED_STEPS - 1] < losses[0]:
        raise RuntimeError(f"train_zoo {name}: the fixed batch's loss did not fall: "
                           f"{losses[:ZOO_TRAIN_FIXED_STEPS]}")
    if any(step != ZOO_TRAIN_LAUNCHES[name] for step in per_step):
        raise RuntimeError(f"train_zoo {name}: launches per step {per_step}, expected "
                           f"{ZOO_TRAIN_LAUNCHES[name]}")
    live = significant(_grad_max(state, batches[0]))
    params = dict(state.model.named_parameters())
    moved, still, exempt, frozen, frozen_moved = 0, [], [], [], []
    for key, value in state.model.state_dict().items():
        changed = not torch.equal(value.cpu(), start[key])
        if param_label(key) == "frozen":  # parameters and buffers
            frozen.append(key)
            frozen_moved += [key] if changed else []
        elif key not in params:
            continue
        elif changed:
            moved += 1
        else:
            (still if key in live else exempt).append(key)
    parts = {prefix: sum(k.startswith(prefix) for k in frozen) for prefix in ZOO_FROZEN[name]}
    log(f"train_zoo {name}: {moved} trainable tensors moved; {len(exempt)} with a gradient "
        f"below {SIGNIFICANT_GRAD} of the largest did not; {len(still)} others did not "
        f"{still}; {len(frozen_moved)} of {len(frozen)} frozen tensors moved "
        f"{frozen_moved[:5]}, frozen tensors by part {parts}")
    if still or frozen_moved or not all(parts.values()):
        raise RuntimeError(f"train_zoo {name}: trainable tensors that did not move, frozen "
                           "ones that did, or a frozen part missing")
    profile = _profile_train_step(state, batches[0], smi, label=f"train_zoo {name} step",
                                  host=False)
    busy = profile.get("device_ms", 0.0) / profile["wall_ms"]
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(exp_dir, ignore_errors=True)
    return dict(launches=launches, per_step=per_step, losses=losses, step_s=step_s,
                first_s=step_s[0], steady_s=steady_s, peak_gb=peak_gb, busy=busy,
                profile=profile, moved=moved, frozen=len(frozen))


def _zoo_train_eval(batch: dict, smi: str) -> dict:
    """One step of PPMStereo-VDA's `train(enable_eval=True)`, its in-training
    evaluation at step 1: result_intrain_1.json written, kernels 1 and 6
    launched for each window (two 4-frame clips, and the image dump's
    window where the logger has a TensorBoard writer), and the evaluation's
    model holding the trained model's tensors bit for bit (its DPT head's
    transposed convolutions too)."""
    import torch

    from ppmstereo_tpu_torch.kernels import corr_lookup as kl
    from ppmstereo_tpu_torch.kernels import play_attention as pa
    from ppmstereo_tpu_torch.train import trainer

    exp_dir = ZOO_TRAIN_DIR / "eval"
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = trainer.TrainConfig(model_name="ppmstereo_vda", exp_dir=str(exp_dir), eval_freq=1,
                              log_freq=1)
    evals, built = [], []
    run_eval = trainer.run_in_training_eval
    build = trainer.build_eval_predictor

    def counted_eval(cfg_, params, step, logger, *args, **kwargs):
        torch.cuda.synchronize()
        before = pa.play_attention.launches, kl.corr_lookup_kernel.launches
        results = run_eval(cfg_, params, step, logger, *args, **kwargs)
        want = LAUNCHES_PER_WINDOW * (2 + (logger.writer is not None))
        evals.append((pa.play_attention.launches - before[0],
                      kl.corr_lookup_kernel.launches - before[1], want))
        return results

    trainer.run_in_training_eval = counted_eval
    trainer.build_eval_predictor = lambda *a, **k: built.append(build(*a, **k)) or built[-1]
    try:
        t0 = time.perf_counter()
        state = trainer.train(cfg, loader=[batch], max_steps=1, enable_eval=True, device="cuda")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        trainer.run_in_training_eval = run_eval
        trainer.build_eval_predictor = build
    dumped = json.loads((exp_dir / "result_intrain_1.json").read_text())
    trained = state.model.state_dict()
    evaluated = built[0].model.state_dict() if len(built) == 1 else {}
    differ = [k for k, v in trained.items() if k not in evaluated or not torch.equal(
        evaluated[k].to(v.dtype), v)]
    log(f"train_zoo ppmstereo_vda train(enable_eval=True) on {smi}: {eval_s:.1f} s; kernel 1 "
        f"and 6 launches in the evaluation and the expected {evals}; EPE "
        f"{dumped['aggregate']['epe_mean']:.3f} px (untrained); {len(differ)} of "
        f"{len(trained)} tensors of the evaluated model differ from the trained one's "
        f"{differ[:5]}")
    if len(evals) != 1 or not evals[0][0] == evals[0][1] == evals[0][2] \
            or not math.isfinite(dumped["aggregate"]["epe_mean"]) or differ \
            or set(evaluated) != set(trained):
        raise RuntimeError(f"train_zoo ppmstereo_vda evaluation: launches {evals}, "
                           f"{dumped['aggregate']}, tensors that differ {differ[:5]}")
    shutil.rmtree(exp_dir, ignore_errors=True)
    return dict(play_launches=evals[0][0], lookup_launches=evals[0][1], seconds=eval_s)


def phase_train_zoo(smi: str) -> dict:
    """Each of ZOO_TRAIN_MODELS: the small parity (`_zoo_train_small`) and a
    short run at TrainConfig() (`_zoo_train_run`) on batches of the
    synthetic fallback; then PPMStereo-VDA's in-training evaluation."""
    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader
    from ppmstereo_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig()
    data = iter(fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                 batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                 seed=ZOO_TRAIN_SEED))
    fixed = next(data)
    batches = [fixed] * ZOO_TRAIN_FIXED_STEPS + [next(data) for _ in range(ZOO_TRAIN_FRESH_STEPS)]
    out, failures = {}, []
    for name in ZOO_TRAIN_MODELS:
        t0 = time.perf_counter()
        small = _zoo_train_small(name, smi)
        failures += small["failures"]
        out[name] = dict(_zoo_train_run(name, batches, smi), small=small,
                         seconds=time.perf_counter() - t0)
    out["eval"] = _zoo_train_eval(fixed, smi)
    if failures:  # read after every model has run, so one run shows them all
        raise RuntimeError("; ".join(failures))
    return out


def _grad_max(state, batch: dict) -> dict:
    """Each trainable tensor's largest |gradient| of the sequence loss on
    `batch`, with no update."""
    import torch

    from ppmstereo_tpu_torch.train.loss import sequence_loss
    from ppmstereo_tpu_torch.train.step import predictions, to_device

    batch = to_device(batch, torch.device("cuda"))
    preds, uncs = predictions(state, batch["left"], batch["right"])
    loss, _ = sequence_loss(preds, batch["disparity"], batch["valid"], uncertainties=uncs)
    loss.backward()
    grads = {n: p.grad.abs().max().cpu() for n, p in state.model.named_parameters()
             if p.grad is not None}
    state.model.zero_grad(set_to_none=True)
    return grads


def _profile_train_step(state, batch: dict, smi: str, label: str = "train step",
                        host: bool = True):
    """One more train step on `batch` under torch.profiler: forward,
    backward and optimiser times by CUDA events, device time by kernel
    group. host=False traces the device alone (no host-side ranges, so no
    Di reading): the trace of a step's ~40,000 launches is then processed
    in a fraction of the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppmstereo_tpu_torch.train.loss import sequence_loss
    from ppmstereo_tpu_torch.train.step import predictions, to_device

    batch = to_device(batch, torch.device("cuda"))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        events[0].record()
        preds, uncs = predictions(state, batch["left"], batch["right"])
        loss, _ = sequence_loss(preds, batch["disparity"], batch["valid"], uncertainties=uncs)
        events[1].record()
        loss.backward()
        events[2].record()
        state.optimizer.step()
        events[3].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms, bwd_ms, opt_ms = (events[i].elapsed_time(events[i + 1]) for i in range(3))
    averages = prof.key_averages()
    # the range "play_attention_di" (kernels/play_attention.py) may also come
    # back as a device-side annotation: it is no kernel, so it is not summed
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != DI_RANGE]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # Di's device time: the kernels launched inside its range (on the host
    # side event), else the span of its device-side annotation
    di_host = [e for e in averages if e.key == DI_RANGE
               and e.device_type != torch.autograd.DeviceType.CUDA]
    di_device = [e for e in averages if e.key == DI_RANGE
                 and e.device_type == torch.autograd.DeviceType.CUDA]
    di_ms = max([e.device_time_total for e in di_host] or [0.0]) / 1e3
    di_span_ms = max([e.self_device_time_total for e in di_device] or [0.0]) / 1e3
    log(f"profiled {label} on {smi}: wall {wall_ms:.1f} ms (profiler on); forward + loss "
        f"{fwd_ms:.1f} ms, backward (with the recomputed iterations) {bwd_ms:.1f} ms, "
        f"optimiser {opt_ms:.1f} ms; device busy {device_ms:.1f} ms "
        f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernel launches; "
        f"Di (rowsum(dO o O), {sum(e.count for e in di_host)} calls) {di_ms:.2f} ms of device time "
        f"in its kernels, {di_span_ms:.2f} ms as a device-side span")
    if device_ms == 0:
        log("profile: the profiler saw no device time; kernel split not measured")
        return dict(wall_ms=wall_ms, forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms)
    groups = {name: 0.0 for name, _ in _TRAIN_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        group = next((name for name, frags in _TRAIN_GROUPS if any(f in key for f in frags)),
                     "other")
        groups[group] += e.self_device_time_total / 1e3
    for name, ms in groups.items():
        log(f"  {name}: {ms:.1f} ms ({100 * ms / device_ms:.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  top kernel {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")
    return dict(wall_ms=wall_ms, forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms,
                device_ms=device_ms, groups=groups, di_ms=di_ms, di_span_ms=di_span_ms)


# one record per kernel: (row key, record name, source, the TPU kernel it replaces)
_KERNEL_RECORDS = (
    ("fwd", "play_attention_fwd", "ppmstereo_tpu_torch/csrc/play_attention_fwd.cu",
     "ppmstereo_tpu/kernels/play_attention.py:58"),
    ("fwd_res", "play_attention_fwd_res", "ppmstereo_tpu_torch/csrc/play_attention_fwd.cu",
     "ppmstereo_tpu/kernels/play_attention.py:58"),
    ("bwd_dq", "play_attention_bwd_dq", "ppmstereo_tpu_torch/csrc/play_attention_bwd.cu",
     "ppmstereo_tpu/kernels/play_attention.py:378"),
    ("bwd_dkv", "play_attention_bwd_dkv", "ppmstereo_tpu_torch/csrc/play_attention_bwd.cu",
     "ppmstereo_tpu/kernels/play_attention.py:425"),
    ("carry", "play_attention_carry", "ppmstereo_tpu_torch/csrc/play_attention_fwd.cu",
     "ppmstereo_tpu/kernels/play_attention.py:145"),
    ("lookup", "corr_lookup", "ppmstereo_tpu_torch/csrc/corr_lookup.cu",
     "ppmstereo_tpu/kernels/corr_lookup.py:36"),
)


def kernel_record(key: str, name: str, source: str, replaces: str, rows: list, launches: int):
    """The JSON record of one kernel: its worst check (by share of its
    limit, over shapes and outputs) and its times at the 1/4 shape."""
    checks = [(row["shape"], out, c) for row in rows for out, c in row["checks"].items()]
    shape, out, worst = max(checks, key=lambda x: x[2]["max_abs_err"] / x[2]["tol"])
    _, _, worst_mean = max(checks, key=lambda x: x[2]["mean_abs_err"] / x[2]["mean_tol"])
    quarter = rows[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": worst["max_abs_err"], "tol": worst["tol"], "worst": f"{out} at {shape}",
        "mean_abs_err": worst_mean["mean_abs_err"], "mean_tol": worst_mean["mean_tol"],
        "ms": quarter["ms"], "plain_ms": quarter["plain_ms"], "bound_ms": quarter["bound_ms"],
        "bound_by": quarter["bound_by"], "library_ms": quarter["library_ms"],
        "shapes": [_shape_summary(row) for row in rows],
    }


def _summary_720p(row: dict) -> dict:
    """A kernel's check and times at the 720p shapes (phase eval)."""
    check = next(iter(row["checks"].values()))
    out = {k: v for k, v in row.items() if k not in ("checks",)}
    out.update(max_share=check["max_abs_err"] / check["tol"],
               mean_share=check["mean_abs_err"] / check["mean_tol"])
    return out


def _shape_summary(row: dict) -> dict:
    """One shape of a kernel record: its times and its worst check as a
    share of the limit (max and mean readings); the log has every check."""
    checks = row["checks"].values()
    out = {k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                               "device_cold_ms") if k in row}
    out["max_share"] = max(c["max_abs_err"] / c["tol"] for c in checks)
    out["mean_share"] = max(c["mean_abs_err"] / c["mean_tol"] for c in checks)
    return out


def main() -> None:
    with phase("device"):
        kind, count, smi = phase_device()
    with phase("build"):
        build_s, sass = phase_build()
    with phase("kernels"):
        rows = phase_kernels(smi)
    with phase("lookup"):
        rows["lookup"], lookup_instances = phase_lookup(smi)
    with phase("small parity"):
        small_run = phase_small_parity()
    with phase("train small parity"):
        phase_train_small_parity()
    with phase("main"):
        main_run = phase_main(smi)
    with phase("profile"):
        phase_profile(main_run, smi)
    with phase("aux"):
        phase_aux(main_run, smi, rows["fwd"][0]["ms"])
    with phase("modes"):
        modes_run = phase_modes(main_run, smi)
    with phase("config"):
        config_run = phase_config(main_run, smi)
    with phase("zoo"):
        zoo_run = phase_zoo(main_run, smi)
    with phase("vda"):
        vda_run = phase_vda(main_run, smi)
    with phase("eval"):
        eval_run = phase_eval(smi)
    with phase("ring"):
        ring_run = phase_ring(main_run, small_run, smi)
    with phase("data"):
        data_run = phase_data(smi)
    with phase("seq"):
        seq_run = phase_seq(main_run, small_run, smi)
    with phase("seq_train"):
        seq_train_run = phase_seq_train(smi)
    with phase("train"):
        train_run = phase_train(smi)
        train_run["recipe"] = phase_train_recipe(smi)
    with phase("train_zoo"):
        train_zoo_run = phase_train_zoo(smi)

    # launches: kernel 1 on the inference path's run and the VDA family's
    # window (PPMStereo-VDA's; StereoAnyVideo launches none), kernels 2-4 on
    # the training paths' runs (PPMStereo's and, in phase train_zoo,
    # PPMStereo-VDA's; the other three models launch none), kernel 5 on the
    # ring path's run (rank 0);
    # kernel 6 on the inference path's, the VDA family's and the ring path's
    # runs (rank 0; test mode), summed with the training path's (0: train
    # mode runs the plain lookup); the data path's rank 0 (its windows for
    # kernels 1 and 6, its train steps for kernels 2-4) adds to each, and so
    # do the seq path's rank 0 (its windows for kernels 1 and 6), its
    # seq x space rank 0 (the small clip's ringed plays for kernel 5) and
    # the seq train path's rank 0 (its train steps for kernels 2-4). Each
    # path is driven with its counts set to 0 just before. Kernels 1 and 6
    # in the modes and eval paths' runs sit beside them.
    vda_play = sum(run["play_launches"] for run in vda_run.values())
    vda_lookup = sum(run["lookup_launches"] for run in vda_run.values())
    lookup = (main_run["lookup_launches"] + vda_lookup + ring_run["lookup_launches"]
              + train_run["launches"]["corr_lookup"])
    train_zoo_launches = {k: sum(train_zoo_run[name]["launches"][k] for name in ZOO_TRAIN_MODELS)
                          for k in train_run["launches"]}
    lookup += (train_zoo_launches["corr_lookup"] + data_run["lookup_launches"]
               + seq_run["lookup_launches"])
    train_launches = {k: n + train_zoo_launches[k] + data_run["launches"][k]
                      + seq_train_run["launches"][k] for k, n in train_run["launches"].items()}
    launches = dict(train_launches,
                    play_attention_fwd=(main_run["launches"] + vda_play + data_run["play_launches"]
                                        + seq_run["play_launches"]),
                    play_attention_carry=ring_run["launches"] + seq_run["carry_launches"],
                    corr_lookup=lookup)
    records = [kernel_record(key, name, source, replaces, rows[key], launches[name])
               for key, name, source, replaces in _KERNEL_RECORDS]
    for record, library in zip(records, ("play_attention_fwd", "play_attention_fwd",
                                         "play_attention_bwd", "play_attention_bwd",
                                         "play_attention_fwd", "corr_lookup")):
        record["build_s"] = build_s[library]
    for record in records[:5]:
        record["sass"] = sass[record["name"]]
    records[5]["ptxas"] = sass["corr_lookup"]
    records[5]["instances"] = lookup_instances
    records[4]["ring"] = ring_run["readings"]
    # measured on rank 0 in the ring phase (None: the profiler saw nothing)
    records[4]["ms_per_window_and_rank"] = ring_run["carry_window_ms"]
    for record, key, kernel in ((records[0], "play_launches", "play"),
                                (records[5], "lookup_launches", "lookup")):
        record["launches_modes"] = {name: run[key] for name, run in modes_run.items()}
        record["launches_eval"] = eval_run[key]
        record["launches_config"] = {name: run[key] for name, run in config_run.items()}
        record["at_720p"] = _summary_720p(eval_run["kernels"][kernel])
    # kernel 6 on the baselines' paths (phase zoo): a 320x512 window of each
    # model, and DynamicStereo's `real` preset run at 720p
    records[5]["launches_zoo"] = {name: zoo_run[name]["lookup_launches"]
                                  for name, _, _ in ZOO_MODELS}
    records[5]["launches_real"] = zoo_run["real"]["lookup_launches"]
    # kernels 1 and 6 in a 320x512 window of each VDA model (phase vda)
    for record, key in ((records[0], "play_launches"), (records[5], "lookup_launches")):
        record["launches_vda"] = {name: run[key] for name, run in vda_run.items()}
        # PPMStereo-VDA's in-training evaluation (phase train_zoo)
        record["launches_train_zoo_eval"] = train_zoo_run["eval"][key]
    # kernels 2-4 in each zoo model's training run (phase train_zoo)
    for record in records[1:4]:
        record["launches_train_zoo"] = {name: train_zoo_run[name]["launches"][record["name"]]
                                        for name in ZOO_TRAIN_MODELS}
    # per rank of the data phase: kernels 2-4 per train step, kernels 1 and
    # 6 over the clip's windows
    for record in records[1:4]:
        record["launches_data_per_step"] = [r["launches"][0][record["name"]]
                                            for r in data_run["readings"]]
        # per rank of the seq train phase: per step (the wrapper's count) and
        # in its traced step (the profiler's), with that step's device ms
        record["launches_seq_train_per_step"] = [r["launches"][0][record["name"]]
                                                 for r in seq_train_run["readings"]]
        record["seq_train_traced"] = [r["traced"][record["name"]]
                                      for r in seq_train_run["readings"]]
    for record, key in ((records[0], "play"), (records[5], "lookup")):
        record["launches_data_windows"] = [r[key] for r in data_run["readings"]]
        # per rank of the seq phase, over the main clip's windows
        record["launches_seq"] = [r[key] for r in seq_run["readings"]]
    # per rank of the seq x space run of the seq phase (the small clip)
    records[4]["launches_seq_space"] = [r["carry"] for r in seq_run["space"]]
    log(f"total {time.perf_counter() - _T0:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
