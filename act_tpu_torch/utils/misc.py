"""Schedules of the Stage-I runner.

The port's own copy of ``act_tpu/utils/misc.py:40-47`` (``cosine_anneal``).
"""
from __future__ import annotations

import math


def cosine_anneal(step: int, start: float, target: float, ntime: int) -> float:
    """Cosine interpolation from ``start`` to ``target`` over ``ntime`` steps,
    then flat (the reference's Gumbel-temperature anneal and KLD-weight ramp,
    tools/runner_autoencoder.py:18-53)."""
    t = min(max(step, 0), ntime) / max(ntime, 1)
    return float(target + 0.5 * (start - target) * (1.0 + math.cos(math.pi * t)))
