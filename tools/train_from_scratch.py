#!/usr/bin/env python3
"""Train the port from scratch with the train CLI, then score the result
with the evaluate CLI beside an untrained model and the anchor.

    python3 tools/train_from_scratch.py [--steps 300] [--out chiprun_out/train300]

1. `cli.train` at TrainConfig() with `--num_steps STEPS` (the one-cycle
   schedule spans them) and `log_freq=10`, from the port's initialisation
   (seed 0), on the training mixture's synthetic fallback (no dataset under
   ./datasets), checkpointing to build/train_from_scratch/ckpt (~780 MB,
   deleted at the end).
2. `cli.evaluate` on the evaluate CLI's synthetic clips (2 sequences of 20
   frames at 256x384, window 10, 10 iterations, bf16) three times: with
   `MODEL.checkpoint=` that directory (the trained model), without a
   checkpoint (the port's initialisation from seed 0: the model the run
   started from), and with checkpoints/anchor_r5.npz.

Prints the loss curve (the loss and EPE of every 10th step), seconds per
step (over each 10), the three EPEs and the card's nvidia-smi name and power
limit, and writes them to OUT/summary.json. Runs on the card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "train300"))
    args = p.parse_args()

    import torch

    from ppmstereo_tpu_torch.cli import evaluate as eval_cli
    from ppmstereo_tpu_torch.cli import train as train_cli

    if not torch.cuda.is_available():
        raise SystemExit("train_from_scratch: a CUDA card is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    run = REPO / "build" / "train_from_scratch"
    shutil.rmtree(run, ignore_errors=True)

    t0 = time.perf_counter()
    state = train_cli.main(["--num_steps", str(args.steps), "--ckpt_path", str(run),
                            "log_freq=10"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    curve = [(r["step"], r["loss"], r["epe"]) for r in records]
    step_s = [1.0 / r["steps_per_s"] for r in records]
    del state
    torch.cuda.empty_cache()

    common = ["dataset_name=synthetic", "sample_len=20", "MODEL.kernel_size=10",
              "MODEL.iters=10"]
    epe = {}
    for name, extra in (("trained", [f"MODEL.checkpoint={run / 'ckpt'}"]), ("untrained", []),
                        ("anchor", [f"MODEL.checkpoint={REPO / 'checkpoints/anchor_r5.npz'}"])):
        results = eval_cli.main(common + extra + [f"exp_dir={out / ('eval_' + name)}"])
        epe[name] = {k: results["aggregate"][k] for k in ("epe_mean", "temp_epe_mean",
                                                          "epe_bad_1px", "fps")}
        torch.cuda.empty_cache()

    summary = dict(device=smi, steps=args.steps, train_s=train_s, curve=curve,
                   seconds_per_step=step_s, eval=epe)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"{args.steps} steps at TrainConfig() from scratch on {smi}: {train_s:.1f} s in "
          f"the train CLI; seconds per step over each 10 {[round(x, 3) for x in step_s]}")
    print("loss curve (step, loss, EPE px): "
          f"{[(s, round(lo, 3), round(e, 3)) for s, lo, e in curve]}")
    for name, r in epe.items():
        print(f"evaluate CLI, synthetic 2 x 20 frames at 256x384, {name}: EPE "
              f"{r['epe_mean']:.4f} px, TEPE {r['temp_epe_mean']:.4f} px, bad-1px "
              f"{r['epe_bad_1px']:.2f} %, fps {r['fps']:.2f}")
    print(smi)
    shutil.rmtree(run, ignore_errors=True)
    if not epe["trained"]["epe_mean"] < epe["untrained"]["epe_mean"]:
        print("the trained model's EPE is not below the untrained model's")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
