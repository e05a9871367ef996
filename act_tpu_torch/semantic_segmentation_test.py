"""Whole-scene S3DIS vote CLI (counterpart of ``semantic_segmentation/main_test.py``).

  python -m act_tpu_torch.semantic_segmentation_test --ckpts <semseg ckpt-best.pth> \\
      [--num_votes 3] [--eval_batch_size 16] [--test_area 5] [--root <stanford_indoor3d dir>]

The JAX CLI's flags without ``--smoke`` (``--num_votes 1`` takes one
round). Without ``--ckpts`` the weights are drawn from ``--seed``. The log
goes to ``work_dirs/sem_seg/<log_dir>/test.log``; the run is on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from act_tpu_torch.ops import resolve_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("semantic segmentation whole-scene test")
    p.add_argument("--npoint", type=int, default=2048)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="matmul/conv activation dtype (statistics and losses f32)")
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--log_dir", type=str, default="act_semseg")
    p.add_argument("--ckpts", type=str, default=None)
    p.add_argument("--root", type=str, default="data/stanford_indoor3d")
    p.add_argument("--num_votes", type=int, default=3)
    p.add_argument("--eval_batch_size", type=int, default=16,
                   help="sliding-window blocks batched in one forward")
    p.add_argument("--num_group", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)  # no card: raise before making directories and logs
    experiment_path = os.path.join("./work_dirs/sem_seg", args.log_dir)
    os.makedirs(experiment_path, exist_ok=True)
    from act_tpu_torch.engine.runner_segmentation import whole_scene_eval
    from act_tpu_torch.utils.logger import get_root_logger
    logger = get_root_logger(log_file=os.path.join(experiment_path, "test.log"),
                             name="SemSegTest")
    whole_scene_eval(root=args.root, npoint=args.npoint, test_area=args.test_area,
                     ckpts=args.ckpts, num_group=args.num_group, dtype=args.dtype,
                     eval_batch_size=args.eval_batch_size, vote_num=args.num_votes,
                     seed=args.seed, device=args.device, logger=logger)


if __name__ == "__main__":
    main()
