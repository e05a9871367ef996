"""Command-line flags and the experiment directory of the port's CLIs.

The port's counterpart of ``act_tpu/utils/parser.py:14-97`` (reference
utils/parser.py) for the flags its runners honour, plus ``--device``. The
experiment directory is ``./work_dirs/<config stem>/<config's parent
directory>/<exp_name>`` (``test_`` prepended under ``--test``), the run's
log file and its copy of the config go there, and ``--resume`` reads that
copy back (``act_tpu/utils/config.py:97-119``). Not ported: the TPU-only flags
(``--scan_steps``, ``--h2d_dtype``, ``--mesh_model_parallel``,
``--ckpt_every``, ``--smoke``), ``--val_freq`` (every epoch validates) and
the tensorboard directory (no writer).
"""
from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path

from act_tpu_torch.utils.config import ConfigDict, cfg_from_yaml_file


def get_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--num_workers", type=int, default=8,
                        help="forked loader workers for real data (synthetic data: none)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--start_ckpts", type=str, default=None,
                        help="weights to start from (.pth)")
    parser.add_argument("--ckpts", type=str, default=None,
                        help="weights to test, validate or finetune from (.pth)")
    parser.add_argument("--vote", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--finetune_model", action="store_true")
    parser.add_argument("--scratch_model", action="store_true")
    parser.add_argument("--way", type=int, default=-1)
    parser.add_argument("--shot", type=int, default=-1)
    parser.add_argument("--fold", type=int, default=-1)
    parser.add_argument("--allow_random_tokenizer", action="store_true",
                        help="pretrain with a random dVAE tokenizer when dvae_config.ckpt is "
                             "missing (otherwise a set but missing path is an error)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.test and args.resume:
        raise ValueError("--test and --resume cannot be both activated")
    if args.resume and args.start_ckpts is not None:
        raise ValueError("--resume and --start_ckpts cannot be both activated")
    stem, parent = Path(args.config).stem, Path(args.config).parent.name
    if args.test:
        args.exp_name = "test_" + args.exp_name
    args.experiment_path = os.path.join("./work_dirs", stem, parent, args.exp_name)
    args.log_name = stem
    os.makedirs(args.experiment_path, exist_ok=True)
    return args


def get_config(args) -> ConfigDict:
    """The run's config: under ``--resume`` the copy in the experiment
    directory, else ``--config``, copied there."""
    copy = os.path.join(args.experiment_path, "config.yaml")
    if args.resume:
        if not os.path.exists(copy):
            raise FileNotFoundError(f"Failed to resume: {copy} not found")
        return cfg_from_yaml_file(copy)
    config = cfg_from_yaml_file(args.config)
    shutil.copy2(args.config, copy)
    return config
