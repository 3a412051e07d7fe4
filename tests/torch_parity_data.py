"""Inputs shared by the port's parity tests of the window modes and the
forward entries: the committed anchor weights in both packages' layouts and
the JAX package's synthetic clips, made from a numpy seed."""

from pathlib import Path

import numpy as np

from ppmstereo_tpu.data.datasets import SyntheticStereoDataset
from ppmstereo_tpu_torch.utils.weights import load_npz

ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"


def load_anchor():
    """(flat {"params/a/b/leaf": f32 array} for the port, the nested tree of
    the same arrays for flax)."""
    flat = {k: v.astype(np.float32) for k, v in load_npz(ANCHOR).items()}
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return flat, tree


def synthetic_clip(frames: int, h: int, w: int, seed: int):
    """(frames, 2, h, w, 3) float32 in [0, 255] and its (frames, h, w)
    |disparity|."""
    ds = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w, seed=seed)
    sample = ds._load_sample(0)
    return sample["img"].astype(np.float32), -sample["disp"][:, 0, :, :, 0]
