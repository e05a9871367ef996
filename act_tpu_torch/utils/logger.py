"""Run logs: each message to standard output and to the run's log file.

The port's counterpart of ``act_tpu/utils/logger.py:16-68`` (reference
utils/logger.py) for one process: ``get_root_logger`` makes a named logger
that writes to stdout and, given a path, to a log file; ``print_log`` sends
a message to a logger given by name or object, to plain ``print`` for
``None``, or nowhere for ``'silent'``.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional, Union

_initialized = set()


def get_logger(name: str, log_file: Optional[str] = None, log_level: int = logging.INFO,
               file_mode: str = "w") -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _initialized:
        return logger
    handlers: list = [logging.StreamHandler(sys.stdout)]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file, file_mode))
    formatter = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for handler in handlers:
        handler.setFormatter(formatter)
        handler.setLevel(log_level)
        logger.addHandler(handler)
    logger.setLevel(log_level)
    logger.propagate = False
    _initialized.add(name)
    return logger


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    name: str = "act_tpu_torch") -> logging.Logger:
    return get_logger(name, log_file, log_level)


def print_log(msg: str, logger: Union[logging.Logger, str, None] = None,
              level: int = logging.INFO) -> None:
    if logger is None:
        print(msg, flush=True)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == "silent":
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f"logger must be a Logger, str, 'silent' or None, got {type(logger)}")
