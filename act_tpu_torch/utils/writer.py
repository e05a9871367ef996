"""TensorBoard writers and the start-up dump of the environment.

The port's counterpart of ``act_tpu/utils/writer.py`` (reference main.py:36-37,
utils/logger.py:132-146): rank 0 gets a ``torch.utils.tensorboard``
``SummaryWriter`` when that module imports (it needs the ``tensorboard``
package), every other rank, and a machine without it, a writer that drops
what it is given, as in the JAX package. The CLIs make a train and a test
writer under ``args.tfboard_path``; the runners feed the same scalars at the
same points as the JAX runners.
"""
from __future__ import annotations

import os
import platform
import sys

from act_tpu_torch.parallel import process_count, process_index


class NullWriter:
    """The writer of a rank other than 0, or of a machine without
    ``tensorboard``: it records nothing."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def get_writer(path: str):
    """A ``SummaryWriter`` writing under ``path`` on rank 0, else a
    :class:`NullWriter`."""
    if process_index() != 0:
        return NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return NullWriter()
    os.makedirs(path, exist_ok=True)
    return SummaryWriter(path)


def collect_env() -> dict:
    """The versions and devices a run's log starts with."""
    import numpy as np
    import torch
    env = {"sys.platform": sys.platform, "Python": sys.version.replace("\n", ""),
           "CPU": platform.processor() or platform.machine(), "numpy": np.__version__,
           "PyTorch": torch.__version__, "CUDA": torch.version.cuda,
           "CUDA available": torch.cuda.is_available(), "process_count": process_count()}
    if torch.cuda.is_available():
        env["GPU"] = ", ".join(torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count()))
    return env


def basic_log(args, logger=None) -> None:
    """The environment and every flag into the run's log (reference
    utils/logger.py:132-146)."""
    from act_tpu_torch.utils.logger import print_log
    for key, val in collect_env().items():
        print_log(f"{key}: {val}", logger=logger)
    for key, val in vars(args).items():
        print_log(f"args.{key} : {val}", logger=logger)
