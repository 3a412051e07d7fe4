#!/usr/bin/env python3
"""Where the strict window modes part from a strict window on one card,
and what the exact encoder cache costs.

    python3 tools/window_bits.py [--out chiprun_out/window_bits.json]

On `chip_smoke.py`'s 320x512 clip (seed 0), with the anchor in bf16 at 10
iterations:

  * cache: the features of frames 10-14 encoded in a call of their own (as
    the encoder cache encodes a window's new frames) against the same frames
    encoded inside frames 5-14 (as a strict window encodes them), with the
    encoders on the whole window at once and on 5 frames a call (the zoo's
    predictor at window 10);
  * batch: windows 0-9 and 5-14 as one batch of two (batch_windows=2)
    against each alone, every intermediate in call order (`_Tap`); the first
    record that is not bit-equal is named;
  * cost: at window 10 (5 frames a call) and at the odd window 9 (gcd(9, 4)
    = 1 frame a call), the encoders alone on a window's frames, whole and in
    calls of gcd(k, k // 2) frames (what an exact cache needs), in
    COST_PAIRS alternating pairs, against the median seconds of
    COST_WINDOWS strict windows encoded in such calls; the window is bound
    by the host, whose speed drifts within a call, so pairs and medians.
    (Over 10 % at window 9, so the zoo encodes a window of an odd length
    whole.)

Prints each reading with the card's nvidia-smi name and power limit and
writes them all to OUT. Runs on the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

COST_PAIRS, COST_WINDOWS = 21, 9
COST_KS = (10, 9)  # window lengths whose exact-cache chunk is timed


class _Tap:
    """Records, in call order, the intermediates of a window that the
    batch comparison reads: the encoders' features, the SST's output and
    each refinement iteration's lookup, motion features, uncertainty, frame
    picks and their scores, the gathered bank (kernel 1's k and v) and the
    play output. Each record is (name, tensor, t): t > 0 for a tensor whose
    batch axis folds (B, T)."""

    def __init__(self, model):
        from ppmstereo_tpu_torch.models import ppm_stereo

        self.records, self.model, self.mod = [], model, ppm_stereo
        self.undo = []

        def wrap(owner, name, record):
            fn = getattr(owner, name)

            def tapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                record(args, out)
                return out

            setattr(owner, name, tapped)
            self.undo.append((owner, name, fn))

        t_of = {}

        def add(name, x, t=0):
            self.records.append((name, x.detach().clone(), t))

        def encode(args, feats):
            t_of["t"] = args[0].shape[1]
            for k in sorted(feats):
                add(f"encoder {k}", feats[k])

        def sst(args, out):
            add("SST f1", out[0])
            add("SST f2", out[1])

        def lookup(args, out):
            add("lookup (kernel 6)", out, t_of["t"])

        def motion(args, out):
            add("motion features", out[0])
            add("motion hidden", out[1])
            add("value", out[2])

        def uncertainty(args, out):
            add("uncertainty", out)

        def play(args, out):
            add("picks", args[3].float())
            add("score_norm", args[4])
            add("play output", out)

        def kernel1(args, out):
            add("bank k (gathered, modulated)", args[1], t_of["t"])
            add("bank v (gathered)", args[2], t_of["t"])
            add("kernel 1 output", out, t_of["t"])

        wrap(model, "encode_frames", encode)
        wrap(model.sst, "forward", sst)
        wrap(self.mod, "corr_lookup_kernel", lookup)
        wrap(self.mod, "play_attention", kernel1)
        for loop in (model.update_block16, model.update_block08, model.update_block04):
            wrap(loop, "_play", play)
            wrap(loop.update_block, "get_motion_and_value", motion)
            wrap(loop.update_block, "get_uncertainty", uncertainty)

    def close(self):
        for owner, name, fn in reversed(self.undo):
            if owner is self.mod:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)  # the instance attribute: the class's again


def _first_divergence(batched: list, single: list, w: int):
    """(index, name, max |diff|) of the first record of window w of a
    batched run that is not bit-equal to the single window's, or None; and
    the max |diff| of every record."""
    first, diffs = None, []
    for i, ((name, xb, t), (_, xs, _)) in enumerate(zip(batched, single)):
        part = xb[w * t:(w + 1) * t] if t else xb[w:w + 1]
        diff = (part.float() - xs.float()).abs().max().item()
        diffs.append((name, diff))
        if first is None and not (part.shape == xs.shape and bool((part == xs).all())):
            first = (i, name, diff)
    return first, diffs


def _encoder_cost(model, left, right, k: int, smi: str) -> dict:
    """The extra seconds of the encoders in the zoo's calls on a window of k
    frames, as a share of a strict window's median seconds."""
    import torch

    chunk = math.gcd(k, k // 2)
    lw, rw = left[:, :k], right[:, :k]
    enc = {None: [], chunk: []}
    window = []
    with torch.no_grad():
        for _ in range(COST_PAIRS):
            for frames in enc:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.encode_frames(lw, rw, frames_per_call=frames)
                torch.cuda.synchronize()
                enc[frames].append(time.perf_counter() - t0)
        for _ in range(COST_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(lw, rw, feats=model.encode_frames(lw, rw, frames_per_call=chunk))
            torch.cuda.synchronize()
            window.append(time.perf_counter() - t0)
    extra = statistics.median(c - w for c, w in zip(enc[chunk], enc[None]))
    window_s = statistics.median(window)
    cs.log(f"cost at window {k} on {smi}: the encoders on {k} frames take "
           f"{statistics.median(enc[None]) * 1e3:.2f} ms whole and "
           f"{statistics.median(enc[chunk]) * 1e3:.2f} ms in calls of {chunk} frames (median "
           f"of {COST_PAIRS} alternating pairs; the pairs' difference {extra * 1e3:.2f} ms); "
           f"a strict {cs.HEIGHT}x{cs.WIDTH} window of {k} frames {window_s:.4f} s (median of "
           f"{COST_WINDOWS}): the exact cache costs {100 * extra / window_s:+.2f} % of it")
    return dict(window=k, frames_per_call=chunk, encoders_whole_s=enc[None],
                encoders_chunked_s=enc[chunk], window_s=window, median_extra_s=extra,
                median_window_s=window_s, share=extra / window_s)


def window_bits(video, smi: str) -> dict:
    import torch

    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.utils.weights import load_npz

    model = model_zoo("PPMStereoModel", kernel_size=cs.WINDOW, iters=cs.ITERS,
                      params=load_npz(cs.ANCHOR)).model
    clip = torch.from_numpy(video).cuda()
    left, right = clip[None, :, 0], clip[None, :, 1]
    chunk = math.gcd(cs.WINDOW, cs.WINDOW // 2)
    out = {"card": smi, "cache": {}, "batch": {}}
    with torch.no_grad():
        for frames in (None, chunk):
            inside = model.encode_frames(left[:, 5:15], right[:, 5:15], frames_per_call=frames)
            alone = model.encode_frames(left[:, 10:15], right[:, 10:15], frames_per_call=frames)
            res = {k: dict(bit_equal=bool(torch.equal(inside[k][:, 5:], alone[k])),
                           max_abs_diff=(inside[k][:, 5:].float() - alone[k].float())
                           .abs().max().item()) for k in sorted(alone)}
            out["cache"][str(frames)] = res
            cs.log(f"cache, encoders on {frames or 'all'} frames a call, on {smi}: frames "
                   f"10-14 encoded alone against inside frames 5-14: {res}")

        runs = {}
        for name, sl in (("batch", [slice(0, 10), slice(5, 15)]), ("w0", [slice(0, 10)]),
                         ("w1", [slice(5, 15)])):
            tap = _Tap(model)
            try:
                lb = torch.cat([left[:, s] for s in sl])
                rb = torch.cat([right[:, s] for s in sl])
                disp = model(lb, rb, feats=model.encode_frames(lb, rb, frames_per_call=chunk))[0]
            finally:
                tap.close()
            runs[name] = (tap.records, disp)
        for w, name in ((0, "w0"), (1, "w1")):
            first, diffs = _first_divergence(runs["batch"][0], runs[name][0], w)
            disp_diff = (runs["batch"][1][w] - runs[name][1][0]).abs()
            out["batch"][name] = dict(
                first=None if first is None else dict(index=first[0], name=first[1],
                                                      max_abs_diff=first[2]),
                records=len(diffs), disparity_max_abs_diff=disp_diff.max().item(),
                disparity_mean_abs_diff=disp_diff.mean().item(),
                first_iteration=[(n, d) for n, d in diffs[:24]])
            cs.log(f"batch_windows=2, window {w} against alone on {smi}: first record not "
                   f"bit-equal {first} of {len(diffs)}; disparity max |diff| "
                   f"{disp_diff.max().item():.3e} px, mean {disp_diff.mean().item():.3e}; the "
                   f"records up to the first 1/16 play: "
                   f"{[(n, f'{d:.2e}') for n, d in diffs[:16]]}")
        del runs
    out["cost"] = [_encoder_cost(model, left, right, k, smi) for k in COST_KS]
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "window_bits.json"))
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("window_bits: a CUDA card is required")
    smi = cs.nvidia_smi_name_and_limit()
    video, _ = cs.synthetic_clip(cs.CLIP_FRAMES, cs.HEIGHT, cs.WIDTH, seed=0)
    out = window_bits(video, smi)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
