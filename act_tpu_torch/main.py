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
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

from act_tpu_torch.utils.logger import get_root_logger, print_log
from act_tpu_torch.utils.parser import get_args, get_config


def setup(argv: Optional[List[str]] = None):
    """Parse the flags, open the run's log file in its experiment directory
    and load the config. Returns (args, config, logger)."""
    args = get_args(argv)
    log_file = os.path.join(args.experiment_path, f"{time.strftime('%Y%m%d_%H%M%S')}.log")
    logger = get_root_logger(log_file=log_file, name=args.log_name)
    config = get_config(args)
    for key, val in vars(args).items():
        print_log(f"args.{key} : {val}", logger=logger)
    return args, config, logger


def main(argv: Optional[List[str]] = None) -> None:
    args, config, logger = setup(argv)
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
                                num_workers=args.num_workers, logger=logger)
    else:
        from act_tpu_torch.engine import runner_pretrain
        runner_pretrain.run_net(config, seed=args.seed, device=args.device,
                                resume=args.resume, start_ckpts=args.start_ckpts,
                                experiment_path=args.experiment_path,
                                allow_random_tokenizer=args.allow_random_tokenizer,
                                num_workers=args.num_workers, logger=logger)


if __name__ == "__main__":
    main()
