"""Device times of a call from ``torch.profiler`` (CUPTI), for ``chip_smoke.py``
and ``act_tpu_torch.kernel_sweep``, and the card's name and power limit
(``card_line``) that the port's measurements print beside their numbers.

On the H100 machines the profiler often drops the records of the first
kernels of a window (in one run of ``chip_smoke.py``, all three sentinels
below in 27 of 79 windows), so that a window's sum can read as a partial
time. Each window therefore opens with three short spin kernels and a 5 ms
pause, finished before the calls and left out of the records (with them every
window of that run was complete), and ``device_ms`` reports no time for a
window in which some kernel name was not recorded a whole number of times per
call.
"""
from __future__ import annotations

import subprocess
import time
from collections import Counter
from typing import Callable, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SENTINEL = "spin_kernel"  # the kernel of torch.cuda._sleep
SENTINELS, SENTINEL_CYCLES, PAUSE_S = 3, 200_000, 0.005


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_events(fn: Callable[[], object], iters: int) -> List:
    """The device kernels of ``iters`` calls of ``fn``, after one call
    outside the window, without the window's sentinels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # device kernels only: the optimizer's user annotations also appear as
    # device-side ranges, spanning kernels already counted
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and SENTINEL not in e.name]


def device_ms(fn: Callable[[], object], iters: int, tries: int = 3) -> Optional[float]:
    """Summed duration of the device kernels a call runs, averaged over
    ``iters`` calls; None when none of ``tries`` windows holds each kernel
    name a multiple of ``iters`` times (a record was lost; with ``iters`` =
    1 only an empty window shows)."""
    for _ in range(tries):
        ev = kernel_events(fn, iters)
        counts = Counter(e.name for e in ev)
        if ev and all(c % iters == 0 for c in counts.values()):
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / iters
    return None
