"""S3DIS semantic-segmentation CLI (counterpart of ``semantic_segmentation/main.py``).

  python -m act_tpu_torch.semantic_segmentation [--ckpts <pretrained .pth>] \\
      [--batch_size 32] [--epoch 60] [--test_area 5] [--root <stanford_indoor3d dir>]

The JAX CLI's flags without its TPU ones (``--scan_steps``, ``--smoke``);
``--mesh_model_parallel T`` shards the transformer over model groups of T
ranks (``act_tpu_torch/utils/parser.py``); ``--steps N`` caps each epoch's
train batches and its evaluation at N batches. The run writes ckpt-best and
its log under ``work_dirs/sem_seg/<log_dir>`` and is on the card unless
``--device cpu`` is given.

On N cards: ``python -m torch.distributed.run --nproc_per_node=N -m
act_tpu_torch.semantic_segmentation ...`` (one process a card, NCCL; ``--batch_size``
is global, each rank trains on its share, rank 0 logs and saves).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from act_tpu_torch.parallel import (destroy_distributed, initialize_distributed,
                                    initialize_model_parallel, local_device)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("semantic segmentation")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epoch", type=int, default=60)
    p.add_argument("--learning_rate", type=float, default=0.0002)
    p.add_argument("--weight_decay", type=float, default=5e-2)
    p.add_argument("--npoint", type=int, default=2048)
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--log_dir", type=str, default="act_semseg")
    p.add_argument("--ckpts", type=str, default=None, help="pretrained student checkpoint")
    p.add_argument("--root", type=str, default="data/stanford_indoor3d")
    p.add_argument("--num_group", type=int, default=128)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="matmul/conv activation dtype (statistics and losses f32)")
    p.add_argument("--steps", type=int, default=None,
                   help="cap each epoch's train batches and its evaluation batches")
    p.add_argument("--num_workers", type=int, default=8, help="forked workers for real data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_model_parallel", type=int, default=1,
                   help="ranks of a tensor-parallel model group (must divide the ranks)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    initialize_distributed(args.device)  # torchrun's group, if launched by it
    try:
        initialize_model_parallel(args.mesh_model_parallel)
        run(args, local_device(args.device))  # no card: raise before directories and logs
    finally:
        destroy_distributed()


def run(args: argparse.Namespace, device) -> None:
    experiment_path = os.path.join("./work_dirs/sem_seg", args.log_dir)
    os.makedirs(experiment_path, exist_ok=True)
    from act_tpu_torch.engine.runner_segmentation import run_semseg
    from act_tpu_torch.utils.logger import get_root_logger
    logger = get_root_logger(log_file=os.path.join(experiment_path, "train.log"), name="SemSeg")
    run_semseg(root=args.root, npoint=args.npoint, batch_size=args.batch_size,
               epoch=args.epoch, learning_rate=args.learning_rate,
               weight_decay=args.weight_decay, test_area=args.test_area, ckpts=args.ckpts,
               num_group=args.num_group, dtype=args.dtype, experiment_path=experiment_path,
               seed=args.seed, device=device, max_steps=args.steps,
               eval_batches=args.steps, num_workers=args.num_workers, logger=logger)


if __name__ == "__main__":
    main()
