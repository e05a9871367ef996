"""Graceful preemption: SIGTERM -> a mid-epoch checkpoint and a clean exit.

Counterpart of ``act_tpu/engine/preemption.py``. Spot instances and
schedulers deliver SIGTERM with a grace period; the trainers poll ``GUARD``
at each step boundary, and once it is set they write ckpt-last with the
loader's cursor ``{epoch, next_batch}`` and return. ``--resume`` then
re-enters the interrupted epoch at that batch. The resumed run equals an
uninterrupted one bit for bit: a step's draws are a function of (seed, step)
(``train_state.step_rngs``), the loader's order of (seed, epoch), and the
step is in the checkpoint.

``at_step`` (an attribute, or the constructor's argument) sets the flag once
that many steps have run in this process: a deterministic stand-in for a
signal. Over several ranks ``check`` takes the MAX of the ranks' flags on
the host's gloo group, so every rank stops at the same step (a rank that
stopped alone would leave the others waiting in the next collective); the
agreement moves one int over the host and never syncs the card.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional

import torch
import torch.distributed as dist

from act_tpu_torch.parallel import mesh


class PreemptionGuard:
    def __init__(self, at_step: Optional[int] = None):
        self._requested = threading.Event()
        self._installed = False
        self._prev_handlers = {}
        self.at_step = at_step

    def install(self, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        """Register the handlers (main thread only; a second call does nothing)."""
        if self._installed:
            return self
        for sig in signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the handlers that ``install`` replaced."""
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self._requested.set()

    def trigger(self) -> None:
        self._requested.set()

    def reset(self) -> None:
        self._requested.clear()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def check(self, steps_done: Optional[int] = None) -> bool:
        """True once the trainer should save and stop: the flag is set (by a
        signal, ``trigger``, or ``steps_done >= at_step``) on this rank or,
        under a process group, on any rank. Every rank must call it at the
        same step boundaries."""
        if self.at_step is not None and steps_done is not None and steps_done >= self.at_step:
            self._requested.set()
        if mesh.is_distributed():
            flag = torch.tensor([int(self._requested.is_set())], dtype=torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.cpu_group())
            if int(flag[0]):
                self._requested.set()
        return self._requested.is_set()


# The process-wide guard: the CLIs install() it, the trainers poll it. A
# library caller who never installs it pays a flag read a step (and, under a
# process group, the ranks' agreement).
GUARD = PreemptionGuard()
