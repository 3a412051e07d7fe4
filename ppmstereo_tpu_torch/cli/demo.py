"""Demo of the port (counterpart of ppmstereo_tpu/cli/demo.py): left and
right frame directories in, disparity out, long videos in chunks of
`--frame_size` frames.

    python -m ppmstereo_tpu_torch.cli.demo --left frames/left \\
        --right frames/right --checkpoint checkpoints/anchor_r5.npz

Writes one colour-mapped PNG a frame (`disparity_00000.png`, ...) through
the port's PNG writer, where the JAX package writes an mp4 with OpenCV, and
with `--save_npz` the raw disparities (N, H, W) as `disparity.npz`. Runs on
`cuda` unless `--device` names another device; raises without a card.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np


def read_frames(path: str) -> np.ndarray:
    """(N, H, W, 3) float32 from the PNG frames of a directory, in name
    order (JPEG frames raise)."""
    from ppmstereo_tpu_torch.data.frame_utils import read_image

    files = sorted(glob.glob(os.path.join(path, "*.png")) + glob.glob(os.path.join(path, "*.jpg")))
    if not files:
        raise FileNotFoundError(f"no frames in {path}")
    return np.stack([read_image(f) for f in files]).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser("ppmstereo_tpu_torch.demo")
    p.add_argument("--device", default="cuda", help="torch device (cuda | cuda:N | cpu)")
    p.add_argument("--left", required=True, help="left frames directory")
    p.add_argument("--right", required=True, help="right frames directory")
    p.add_argument("--output", default="./outputs/demo")
    p.add_argument("--model", default="PPMStereoModel")
    p.add_argument("--checkpoint", default="", help=".npz or a trainer directory")
    p.add_argument("--kernel_size", type=int, default=20)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--frame_size", type=int, default=150, help="chunk length for long videos")
    p.add_argument("--save_npz", action="store_true")
    p.add_argument("--model_kwargs", default="",
                   help='extra model-constructor kwargs as "k=v,k2=v2", as on the evaluate CLI')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ppmstereo_tpu_torch.cli.evaluate import _parse_model_kwargs, load_checkpoint
    from ppmstereo_tpu_torch.data.png import write_png
    from ppmstereo_tpu_torch.evaluation.visualization import colorize_disparity
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    kwargs = _parse_model_kwargs(args.model_kwargs)
    kwargs.setdefault("device", args.device)
    predictor = model_zoo(args.model, kernel_size=args.kernel_size, iters=args.iters, **kwargs)
    if args.checkpoint:
        load_checkpoint(predictor, args.checkpoint)

    left, right = read_frames(args.left), read_frames(args.right)
    if left.shape != right.shape:
        raise ValueError(f"left frames {left.shape} and right frames {right.shape} differ")
    video = np.stack([left, right], axis=1)  # (N, 2, H, W, 3)

    disps = []
    for s in range(0, len(video), args.frame_size):
        chunk = video[s:s + args.frame_size]
        disps.append(predictor({"stereo_video": chunk})["disparity"])
        logging.info(f"chunk {s}:{s + len(chunk)} done")
    disp = np.concatenate(disps)[..., 0]  # (N, H, W)

    os.makedirs(args.output, exist_ok=True)
    vmin, vmax = np.percentile(disp, 2), np.percentile(disp, 98)
    for i, frame in enumerate(disp):
        write_png(os.path.join(args.output, f"disparity_{i:05d}.png"),
                  colorize_disparity(frame, vmin, vmax))
    if args.save_npz:
        np.savez_compressed(os.path.join(args.output, "disparity.npz"), disparity=disp)
    logging.info(f"wrote {len(disp)} frames to {args.output}")
    return disp


if __name__ == "__main__":
    main()
