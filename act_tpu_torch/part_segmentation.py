"""ShapeNetPart part-segmentation CLI (counterpart of ``part_segmentation/main.py``).

  python -m act_tpu_torch.part_segmentation [--ckpts <pretrained .pth>] \\
      [--batch_size 16] [--epoch 300] [--npoint 2048] [--root <ShapeNetPart dir>]

The JAX CLI's flags without its TPU ones (``--scan_steps``,
``--mesh_model_parallel``, ``--smoke``); ``--steps N`` caps each epoch's
train batches and its evaluation at N batches. The run writes ckpt-best and
its log under ``work_dirs/part_seg/<log_dir>`` and is on the card unless
``--device cpu`` is given.

On N cards: ``python -m torch.distributed.run --nproc_per_node=N -m
act_tpu_torch.part_segmentation ...`` (one process a card, NCCL; ``--batch_size``
is global, each rank trains on its share, rank 0 logs and saves).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from act_tpu_torch.parallel import destroy_distributed, initialize_distributed, local_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("part segmentation")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epoch", type=int, default=300)
    p.add_argument("--learning_rate", type=float, default=0.0002)
    p.add_argument("--weight_decay", type=float, default=5e-2)
    p.add_argument("--npoint", type=int, default=2048)
    p.add_argument("--normal", action="store_true")
    p.add_argument("--log_dir", type=str, default="act_partseg")
    p.add_argument("--ckpts", type=str, default=None, help="pretrained student checkpoint")
    p.add_argument("--root", type=str,
                   default="data/shapenetcore_partanno_segmentation_benchmark_v0_normal")
    p.add_argument("--num_group", type=int, default=128)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="matmul/conv activation dtype (statistics and losses f32)")
    p.add_argument("--steps", type=int, default=None,
                   help="cap each epoch's train batches and its evaluation batches")
    p.add_argument("--num_workers", type=int, default=8, help="forked workers for real data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    initialize_distributed(args.device)  # torchrun's group, if launched by it
    try:
        run(args, local_device(args.device))  # no card: raise before directories and logs
    finally:
        destroy_distributed()


def run(args: argparse.Namespace, device) -> None:
    experiment_path = os.path.join("./work_dirs/part_seg", args.log_dir)
    os.makedirs(experiment_path, exist_ok=True)
    from act_tpu_torch.engine.runner_segmentation import run_partseg
    from act_tpu_torch.utils.logger import get_root_logger
    logger = get_root_logger(log_file=os.path.join(experiment_path, "train.log"), name="PartSeg")
    run_partseg(root=args.root, npoint=args.npoint, batch_size=args.batch_size,
                epoch=args.epoch, learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, normal=args.normal, ckpts=args.ckpts,
                num_group=args.num_group, dtype=args.dtype, experiment_path=experiment_path,
                seed=args.seed, device=device, max_steps=args.steps,
                eval_batches=args.steps, num_workers=args.num_workers, logger=logger)


if __name__ == "__main__":
    main()
