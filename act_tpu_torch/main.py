"""The port's pretrain / finetune / test CLI (counterpart of ``main.py:15-68``).

  python -m act_tpu_torch.main --config cfgs/pretrain/pretrain_act_distill.yaml
  python -m act_tpu_torch.main --config <finetune yaml> --finetune_model --ckpts <stage-II .pth>
  python -m act_tpu_torch.main --config <finetune yaml> --test --ckpts <finetuned .pth>

The same flags, configs and experiment directory as the JAX CLI
(``act_tpu_torch/utils/parser.py``): without ``--test``,
``--finetune_model`` or ``--scratch_model`` it pretrains
(``engine/runner_pretrain.run_net``, the Stage-I dVAE from
``dvae_config.ckpt``); a finetune starts from ``--ckpts`` (or
``--start_ckpts``) and runs ``engine/runner_finetune.run_net``; ``--test``
runs ``runner_finetune.test_net``. The run is on the card unless
``--device cpu`` is given.

On N cards: ``python -m torch.distributed.run --nproc_per_node=N -m
act_tpu_torch.main ...`` (one process a card, NCCL; the configs' batch sizes
are global); ``--mesh_model_parallel T`` makes model groups of T ranks that
share one copy of the transformers, each rank a shard of their MLPs and
attention heads (T must divide the ranks and every sharded width; a
checkpoint keeps the one-process layout). A SIGTERM makes the trainer write ckpt-last with its position
in the epoch at the next step boundary and exit 0 after a ``[PREEMPT]``
line; ``--resume`` continues inside that epoch. ``--val_freq N`` validates
(or probes) after every N-th epoch; the train and test TensorBoard writers
(``utils/writer.py``) go under ``args.tfboard_path``.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.parallel import (destroy_distributed, initialize_distributed,
                                    initialize_model_parallel)
from act_tpu_torch.utils.logger import get_root_logger, print_log
from act_tpu_torch.utils.parser import get_args, get_config
from act_tpu_torch.utils.writer import basic_log, get_writer


def setup(argv: Optional[List[str]] = None):
    """Parse the flags, install the preemption guard (SIGTERM), join the
    process group of torchrun's environment (``nccl`` on the card, ``gloo``
    with ``--device cpu``; none without torchrun) and lay it out as the
    ``--mesh_model_parallel`` grid (a ``ValueError`` unless it divides the
    ranks), open the run's log file in
    its experiment directory and load the config. Returns (args, config,
    logger)."""
    args = get_args(argv)
    GUARD.install()
    initialize_distributed(args.device)
    try:
        initialize_model_parallel(args.mesh_model_parallel)
    except ValueError:
        destroy_distributed()
        raise
    log_file = os.path.join(args.experiment_path, f"{time.strftime('%Y%m%d_%H%M%S')}.log")
    logger = get_root_logger(log_file=log_file, name=args.log_name)
    config = get_config(args)
    basic_log(args, logger)
    if args.sync_bn:
        print_log("[ARGS] --sync_bn: BatchNorm statistics are global over the ranks by "
                  "construction; the flag changes nothing", logger=logger)
    return args, config, logger


def writers(args):
    """The train and test writers of the run (``main.py:29-31``)."""
    return (get_writer(os.path.join(args.tfboard_path, "train")),
            get_writer(os.path.join(args.tfboard_path, "test")))


def main(argv: Optional[List[str]] = None) -> None:
    args, config, logger = setup(argv)
    train_writer, val_writer = writers(args)
    try:
        run(args, config, logger, train_writer)
    finally:
        train_writer.close()
        val_writer.close()
        destroy_distributed()


def run(args, config, logger, train_writer=None) -> None:
    if args.test:
        from act_tpu_torch.engine import runner_finetune
        runner_finetune.test_net(config, ckpts=args.ckpts, seed=args.seed, device=args.device,
                                 vote=args.vote, way=args.way, num_workers=args.num_workers,
                                 logger=logger)
    elif args.finetune_model or args.scratch_model:
        from act_tpu_torch.engine import runner_finetune
        ckpts = (args.ckpts or args.start_ckpts) if args.finetune_model else None
        runner_finetune.run_net(config, seed=args.seed, device=args.device, vote=args.vote,
                                ckpts=ckpts, resume=args.resume,
                                experiment_path=args.experiment_path, way=args.way,
                                shot=args.shot, fold=args.fold,
                                num_workers=args.num_workers, val_freq=args.val_freq,
                                logger=logger)
    else:
        from act_tpu_torch.engine import runner_pretrain
        runner_pretrain.run_net(config, seed=args.seed, device=args.device,
                                resume=args.resume, start_ckpts=args.start_ckpts,
                                experiment_path=args.experiment_path,
                                allow_random_tokenizer=args.allow_random_tokenizer,
                                num_workers=args.num_workers, val_freq=args.val_freq,
                                train_writer=train_writer, logger=logger)


if __name__ == "__main__":
    main()
