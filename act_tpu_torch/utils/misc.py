"""Schedules of the runners and the point-cloud normalization.

The port's own copy of ``act_tpu/utils/misc.py:40-47, 56-66, 83-91``
(``cosine_anneal``, ``bn_momentum_schedule``, ``pc_normalize``).
"""
from __future__ import annotations

import math

import numpy as np


def cosine_anneal(step: int, start: float, target: float, ntime: int) -> float:
    """Cosine interpolation from ``start`` to ``target`` over ``ntime`` steps,
    then flat (the reference's Gumbel-temperature anneal and KLD-weight ramp,
    tools/runner_autoencoder.py:18-53)."""
    t = min(max(step, 0), ntime) / max(ntime, 1)
    return float(target + 0.5 * (start - target) * (1.0 + math.cos(math.pi * t)))


def bn_momentum_schedule(epoch, bn_momentum: float = 0.1, bn_decay: float = 0.5,
                         decay_step: int = 20, lowest_decay: float = 0.01) -> float:
    """BN-momentum decay (reference ``build_lambda_bnsche``, utils/misc.py:60-66)
    in torch's convention, the weight of the new batch statistic:
    ``max(bn_momentum * bn_decay ** (epoch / decay_step), lowest_decay)``."""
    return max(bn_momentum * bn_decay ** (epoch / decay_step), lowest_decay)


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center a (N, 3) cloud on its centroid and scale it into the unit sphere
    (reference datasets/ModelNetDataset.py:20)."""
    pc = pc - pc.mean(axis=0)
    m = np.sqrt(np.einsum("ij,ij->i", pc, pc).max())
    return pc / max(m, 1e-12)
