"""Profiling hooks of the trainers: the trace window and the step meters.

The port's counterpart of ``act_tpu/utils/profiling.py``. Set
``ACT_TPU_PROFILE=/path/to/dir`` to capture a ``torch.profiler`` trace of
steps [start, stop) of Stage II's ``run_net``: one Kineto/Chrome trace file,
``<host>_<pid>.<ns>.pt.trace.json`` in that directory, which Perfetto or
chrome://tracing open and ``python -m act_tpu_torch.profile_step`` reports
(``PROFILE_REPORT_ONLY=1 PROFILE_DIR=dir``). The variable only opens the
window: nothing that is computed changes. ``StepTimer`` keeps the wall-clock
batch and data-time meters (the reference's AverageMeter pairs,
tools/runner_pretrain.py:110-126).

On the card a window opens with the spin kernels and the pause of
``act_tpu_torch/profiling.py`` (without them the profiler drops the first
records of a window there) after a device synchronize, and closes after
another, so that it holds exactly the kernels of the steps inside it; the
spin kernels are left out of every report.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from act_tpu_torch.profiling import PAUSE_S, SENTINEL_CYCLES, SENTINELS
from act_tpu_torch.utils.meters import AverageMeter

ENV = "ACT_TPU_PROFILE"
STEPS_KEY = "act_tpu_steps"  # the trace's metadata entry: the steps its window holds
TRACE_SUFFIX = ".pt.trace.json"


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def open_window(device=None) -> profile:
    """Start a profiler window: CPU activity, and CUDA activity when
    ``device`` is a card, where the window opens after a synchronize with
    ``SENTINELS`` spin kernels and a pause, all finished before it returns."""
    cuda = _on_card(device)
    if cuda:
        torch.cuda.synchronize(device)
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    if cuda:
        with torch.cuda.device(device):
            for _ in range(SENTINELS):
                torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize(device)
        time.sleep(PAUSE_S)
    return prof


def close_window(prof: profile, directory: str, steps: int, device=None) -> str:
    """End the window of ``open_window`` (after a synchronize on a card) and
    write it to ``directory`` as one Kineto/Chrome trace, with ``steps`` (the
    steps it holds) in its metadata. Returns the file's path."""
    if _on_card(device):
        torch.cuda.synchronize(device)
    prof.add_metadata(STEPS_KEY, str(int(steps)))
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{socket.gethostname()}_{os.getpid()}."
                                   f"{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    return path


class TraceContext:
    """Traces steps [start, stop) when ACT_TPU_PROFILE is set; no-op
    otherwise. ``step(i)`` is called after step ``i`` (counted from 1) has
    been taken; ``close()`` ends an open window early (a preemption, the end
    of the run). ``path`` is the trace written, else None."""

    def __init__(self, start: int = 10, stop: int = 15, device=None):
        self.dir = os.environ.get(ENV)
        self.start_step = start
        self.stop_step = stop
        self.device = device
        self.path: Optional[str] = None
        self._prof: Optional[profile] = None
        self._last = start

    def step(self, i: int) -> None:
        if not self.dir:
            return
        if i == self.start_step and self._prof is None:
            self._prof = open_window(self.device)
            self._last = i
        elif self._prof is not None:
            self._last = i
            if i == self.stop_step:
                self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self.path = close_window(prof, self.dir, self._last - self.start_step, self.device)


class StepTimer:
    """data-time / batch-time meters around a loader loop."""

    def __init__(self):
        self.batch_time = AverageMeter(["BatchTime"])
        self.data_time = AverageMeter(["DataTime"])
        self._tic = time.time()

    def data_loaded(self) -> None:
        self.data_time.update([time.time() - self._tic])

    def step_done(self) -> None:
        now = time.time()
        self.batch_time.update([now - self._tic])
        self._tic = now

    def summary(self) -> str:
        return (f"BatchTime={self.batch_time.avg(0):.3f}s "
                f"DataTime={self.data_time.avg(0):.3f}s")
