"""Training entry point of the port, with the JAX CLI's flag names
(ppmstereo_tpu/cli/train.py), plus `--device`:

    python -m ppmstereo_tpu_torch.cli.train --name ppmstereo --num_steps 200000 \\
        --batch_size 2 --lr 0.0003 --sample_len 5 --train_iters 10

    # the other models of the zoo: ppmstereo_vda, dynamicstereo, bidastereo,
    # stereoanyvideo (memstereo is ppmstereo)
    python -m ppmstereo_tpu_torch.cli.train --name stereoanyvideo

    # a YAML TrainConfig preset, with dotted overrides on top
    python -m ppmstereo_tpu_torch.cli.train --config preset.yaml num_steps=300

    # a tiny run on the CPU
    python -m ppmstereo_tpu_torch.cli.train --device cpu --image_size 64 128 \\
        --sample_len 3 --train_iters 1 --num_steps 2 --name dynamicstereo

    # data-parallel on N cards: one process per card, each loading its
    # block of every global batch of --batch_size clips
    torchrun --nproc_per_node N -m ppmstereo_tpu_torch.cli.train --batch_size 2N

    # each clip's frames over 2 cards (PPMStereo; --sample_len must divide
    # by --seq_parallel), and data x seq = 2 x 2 on 4
    torchrun --nproc_per_node 2 -m ppmstereo_tpu_torch.cli.train --seq_parallel 2 \\
        --sample_len 6
    torchrun --nproc_per_node 4 -m ppmstereo_tpu_torch.cli.train --seq_parallel 2 \\
        --sample_len 6 --batch_size 2

With --config the preset (read by `utils/config.py::load_yaml`, its
`model_kwargs` a mapping of the model config's fields) replaces the other flags
but --device; trailing KEY=VALUE arguments override TrainConfig fields
either way (e.g. log_freq=1). Runs on `cuda` unless `--device` names another
device; raises without a card. Under torchrun the CLI joins the launch's
process group (`parallel/mesh.py::join_group`: rank r runs on card
LOCAL_RANK, over NCCL when every rank has a card of its own, over gloo
when ranks share one) and trains over the mesh (data, seq) =
(--data_parallel, --seq_parallel), which must span the group
(--data_parallel 0: the ranks that --seq_parallel leaves, cut to a divisor
of the batch). --seq_parallel above 1 spreads each clip's frames over the
seq axis, for ppmstereo (and memstereo) only: the other models' seq axis
is ROADMAP §1 item 7.1b. --space_parallel above 1 raises (item 7.3's space
half, after item 7.2).
As in the JAX CLI, the in-training evaluation is off here (`train(cfg)`);
--evaluate_freq sets its interval for callers of
`train(..., enable_eval=True)`.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    p = argparse.ArgumentParser("ppmstereo_tpu_torch.train")
    p.add_argument("--device", default="cuda", help="torch device (cuda | cuda:N | cpu)")
    p.add_argument("--name", default="ppmstereo",
                   help="ppmstereo | memstereo | ppmstereo_vda | dynamicstereo | bidastereo | "
                        "stereoanyvideo")
    p.add_argument("--config", default=None, help="YAML TrainConfig preset")
    p.add_argument("--ckpt_path", default="./outputs/train")
    p.add_argument("--num_steps", type=int, default=200_000)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--sample_len", type=int, default=5)
    p.add_argument("--train_iters", type=int, default=10)
    p.add_argument("--image_size", type=int, nargs=2, default=[320, 512])
    p.add_argument("--no_mixed_precision", action="store_true")
    p.add_argument("--evaluate_freq", type=int, default=5000)
    p.add_argument("--save_freq", type=int, default=5000)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--seq_parallel", type=int, default=1)
    p.add_argument("--space_parallel", type=int, default=1)
    p.add_argument("overrides", nargs="*", help="dotted KEY=VALUE overrides")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch.distributed as dist

    from ppmstereo_tpu_torch.parallel.mesh import join_group
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, train
    from ppmstereo_tpu_torch.utils.config import apply_overrides, load_yaml

    if args.config:
        cfg = load_yaml(TrainConfig, args.config, overrides=args.overrides)
    else:
        cfg = TrainConfig(
            model_name=args.name,
            num_steps=args.num_steps,
            batch_size=args.batch_size,
            lr=args.lr,
            sample_len=args.sample_len,
            train_iters=args.train_iters,
            crop_size=tuple(args.image_size),
            mixed_precision=not args.no_mixed_precision,
            exp_dir=args.ckpt_path,
            eval_freq=args.evaluate_freq,
            save_freq=args.save_freq,
            num_workers=args.num_workers,
            seed=args.seed,
            data_parallel=args.data_parallel,
            seq_parallel=args.seq_parallel,
            space_parallel=args.space_parallel,
        )
        apply_overrides(cfg, args.overrides)
    device, started = join_group(args.device)
    try:
        return train(cfg, device=device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
