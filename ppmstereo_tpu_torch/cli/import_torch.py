"""A reference PyTorch checkpoint -> the flat parameter file both packages
read (counterpart of ppmstereo_tpu/cli/import_torch.py):

    python -m ppmstereo_tpu_torch.cli.import_torch ckpt.pth out.npz --model DynamicStereoModel
    python -m ppmstereo_tpu_torch.cli.evaluate \\
        --config ppmstereo_tpu_torch/configs/eval_real.yaml MODEL.checkpoint=out.npz

The state dict is read with `utils/torch_import.py::load_state_dict`
(`model` / `state_dict` / `module.` unwrapped; `torch.load(weights_only=
True)`, so a pickle that needs arbitrary objects is refused), each tensor is
written at its table's flax path (`utils/ppm_mapping.py`,
`utils/zoo_mappings.py`) in the flax layout, and the file is the JAX CLI's
format: a compressed npz of float16 arrays named by flax path
("fnet/Conv_0/Conv_0/kernel", ...). `MODEL.checkpoint=` of either package's
evaluate CLI takes it; the port's carry transposes each tensor once more,
into its own layout. The conversion runs on the host: no device is used.

Models: PPMStereoModel, PPMStereoVDAModel, DynamicStereoModel,
BiDAStereoModel (with its RAFT when the checkpoint holds `raft.model.*`) and
StereoAnyVideoModel (with its Video-Depth-Anything backbone when the
checkpoint holds `depthnet.depthanything.*`). The DPT head's transposed
convolutions take `vda_transform` (the JAX CLI converts them as Conv2d
weights, swapping their in and out channels and leaving them unflipped);
the backbone's tensors that no model reads (`mask_token`, the scalar depth
head `output_conv2`, ...) are not counted as unmapped.

The exit code is 1 when a mapped key is missing from the checkpoint or a
live tensor of the checkpoint has no destination (`--allow_partial`: 0),
since a conversion that silently dropped weights would give a model that
is not the checkpoint's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ppmstereo_tpu_torch.models.ppm_stereo import SHIPPED_ATTENTION

MODELS = ("PPMStereoModel", "PPMStereoVDAModel", "DynamicStereoModel", "BiDAStereoModel",
          "StereoAnyVideoModel")


def _template(model) -> dict[str, np.ndarray]:
    """The model's parameters in the flat flax layout, without the "params/"
    prefix: the shapes (and the values of anything no table names)."""
    from ppmstereo_tpu_torch.utils.weights import model_to_flax

    flat = model_to_flax(model)
    return {k.removeprefix("params/"): v for k, v in flat.items()}


def _num_frames(args, sd) -> int:
    """The time embedding's frames: the flag, else the checkpoint's, else 5."""
    if args.num_frames is not None:
        return args.num_frames
    if "time_embed" in sd:
        return int(sd["time_embed"].shape[1])
    return 5


def build_and_map(args, sd: dict) -> tuple[dict[str, np.ndarray], list[str], list[str]]:
    """(the flat flax parameters with the checkpoint's tensors, the missing
    keys, the live tensors without a destination)."""
    from ppmstereo_tpu_torch.utils.ppm_mapping import (
        grn_transform,
        is_dead_reference_key,
        ppmstereo_mapping,
    )
    from ppmstereo_tpu_torch.utils.torch_import import import_by_mapping
    from ppmstereo_tpu_torch.utils.vda_mapping import (
        is_transposed_conv_key,
        is_vda_dead_key,
        vda_transform,
    )
    from ppmstereo_tpu_torch.utils.zoo_mappings import (
        bidastereo_mapping,
        dynamicstereo_mapping,
        is_zoo_dead_key,
        ppmstereo_vda_mapping,
        stereoanyvideo_mapping,
    )

    def vda_dead(key, mapping):
        return is_zoo_dead_key(key, mapping) or is_vda_dead_key(key, mapping)

    if args.model == "PPMStereoModel":
        from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig

        cfg = PPMStereoConfig(mixed_precision=False, use_cnet=not args.no_cnet,
                              attention_type=args.attention_type, num_frames=_num_frames(args, sd))
        model = PPMStereo(cfg, iters=2, test_mode=True)
        mapping = ppmstereo_mapping(attention_type=args.attention_type, use_cnet=not args.no_cnet)
        dead = is_dead_reference_key
    elif args.model == "PPMStereoVDAModel":
        from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig

        cfg = PPMStereoConfig(mixed_precision=False, use_cnet=True, use_vfm=True,
                              attention_type=args.attention_type, num_frames=_num_frames(args, sd))
        model = PPMStereo(cfg, iters=2, test_mode=True)
        mapping, dead = ppmstereo_vda_mapping(attention_type=args.attention_type), vda_dead
    elif args.model == "StereoAnyVideoModel":
        from ppmstereo_tpu_torch.models.stereoanyvideo import StereoAnyVideo, StereoAnyVideoConfig

        model = StereoAnyVideo(StereoAnyVideoConfig(mixed_precision=False), iters=2,
                               test_mode=True)
        # the backbone's tensors are `depthnet.depthanything.*` (the JAX CLI
        # looks for "backbone.*", which this table never names, and so leaves
        # them out)
        mapping = stereoanyvideo_mapping(
            include_vda=any(k.startswith("depthnet.depthanything.") for k in sd))
        dead = vda_dead
    elif args.model == "DynamicStereoModel":
        from ppmstereo_tpu_torch.models.dynamic_stereo import DynamicStereo, DynamicStereoConfig

        cfg = DynamicStereoConfig(mixed_precision=False, num_frames=_num_frames(args, sd))
        model = DynamicStereo(cfg, iters=2, test_mode=True)
        mapping, dead = dynamicstereo_mapping(), is_zoo_dead_key
    else:
        from ppmstereo_tpu_torch.models.bidastereo import BiDAStereo, BiDAStereoConfig

        model = BiDAStereo(BiDAStereoConfig(mixed_precision=False), iters=2, test_mode=True)
        # the frozen RAFT's tensors are `raft.model.*` in the reference (the
        # JAX CLI looks for "raft.fnet.conv1.weight", which the table never
        # names, and so leaves them unmapped)
        mapping = bidastereo_mapping(include_raft=any(k.startswith("raft.model.") for k in sd))
        dead = is_zoo_dead_key

    def transform(key, w):
        return vda_transform(key, w) if is_transposed_conv_key(key) else grn_transform(key, w)

    flat, missing = import_by_mapping(sd, _template(model), mapping, transform=transform)
    unmapped = sorted(k for k in set(sd) - set(mapping) if not dead(k, mapping))
    return flat, missing, unmapped


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ppmstereo_tpu_torch.import_torch",
                                description="Convert a reference PyTorch checkpoint to the "
                                            "flat parameter npz")
    p.add_argument("ckpt", help=".pth state dict (or .npz of numpy arrays)")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--model", default="PPMStereoModel", choices=MODELS)
    p.add_argument("--attention_type", default=SHIPPED_ATTENTION,
                   help="the architecture switch the checkpoint was trained with (PPMStereo "
                        "and PPMStereo-VDA)")
    p.add_argument("--no_cnet", action="store_true",
                   help="a PPMStereo checkpoint trained without the ConvNeXt context net")
    p.add_argument("--num_frames", type=int, default=None,
                   help="the time embedding's frames; default: the checkpoint's")
    p.add_argument("--allow_partial", action="store_true",
                   help="exit 0 even with missing or unmapped keys")
    args = p.parse_args(argv)

    from ppmstereo_tpu_torch.utils.torch_import import load_state_dict

    sd = load_state_dict(args.ckpt)
    print(f"loaded {len(sd)} tensors from {args.ckpt}", flush=True)
    flat, missing, unmapped = build_and_map(args, sd)
    np.savez_compressed(args.out, **{k: np.asarray(v).astype(np.float16) for k, v in flat.items()})
    print(f"wrote {len(flat)} arrays to {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)",
          flush=True)
    if missing:
        print(f"MISSING from the checkpoint ({len(missing)}): {missing[:10]}", flush=True)
    if unmapped:
        print(f"UNMAPPED live tensors ({len(unmapped)}): {unmapped[:10]}", flush=True)
    print("evaluate with:\n  python -m ppmstereo_tpu_torch.cli.evaluate "
          f"MODEL.model_name={args.model} MODEL.checkpoint={args.out}", flush=True)
    return 1 if (missing or unmapped) and not args.allow_partial else 0


if __name__ == "__main__":
    sys.exit(main())
