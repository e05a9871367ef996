"""Schedules of the runners, the point-cloud helpers and the parameter
summary.

The port's own copy of ``act_tpu/utils/misc.py``: ``worker_seed_fn``,
``cosine_anneal``, ``bn_momentum_schedule``, ``pc_normalize``,
``random_subsample``, ``random_dropping``, ``separate_point_cloud`` and
``summary_parameters`` (reference utils/misc.py). Where JAX takes a PRNG key
the port takes a ``torch.Generator``, and each random helper calls a
deterministic core with its draw (the subsample's indices, the dropped-group
count, the crop direction), which the tests hold to JAX's with JAX's draws.
``get_ptcloud_img`` is not ported (matplotlib).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn


def worker_seed_fn(worker_id: int, base_seed: int) -> np.random.Generator:
    """The numpy generator of data-loading worker ``worker_id`` (reference
    ``worker_init_fn``, misc.py:49)."""
    return np.random.default_rng(base_seed + worker_id)


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


def take_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) clouds, (B, S) int indices -> (B, S, 3): the coordinate
    gather (``ops.gather_coords``: the gather kernel on the card)."""
    from act_tpu_torch import ops
    return ops.gather_coords(points.contiguous(), idx.to(torch.int32).contiguous())


def random_subsample(points: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` points of each (B, N, 3) cloud, the first ``n`` of a random
    permutation drawn from ``gen`` (on the clouds' device) for each cloud."""
    B, N = points.shape[:2]
    idx = torch.stack([torch.randperm(N, generator=gen, device=points.device)[:n]
                       for _ in range(B)])
    return take_points(points, idx)


def random_dropping(points: torch.Tensor, gen: torch.Generator, group_size: int = 32,
                    max_drop_groups: int = 45, num_group: int = 64) -> torch.Tensor:
    """Drop up to ``max_drop_groups`` FPS groups of each cloud and refill the
    (B, N, 3) batch by repetition: the count drawn from ``gen`` (on the
    clouds' device), uniform in [0, max_drop_groups], one for the batch,
    then ``drop_groups``."""
    num_drop = int(torch.randint(0, max_drop_groups + 1, (), generator=gen,
                                 device=points.device))
    return drop_groups(points, num_drop, group_size, num_group)


def drop_groups(points: torch.Tensor, num_drop: int, group_size: int = 32,
                num_group: int = 64) -> torch.Tensor:
    """The core of ``random_dropping`` (``act_tpu/utils/misc.py:102-122``, a
    static-shape form of the reference's ragged crop, misc.py:262-274):
    ``num_group`` FPS centers, the ``group_size`` nearest points of each
    (k-smallest), the points of groups [0, num_drop) replaced by those of
    the last group, and the first N of the G x M indices gathered. Through
    the FPS, k-smallest and gather kernels on the card."""
    from act_tpu_torch import ops
    B, N, _ = points.shape
    points = points.contiguous()
    centers = take_points(points, ops.furthest_point_sample(points, num_group))
    _, group_idx = ops.knn(points, centers, group_size)  # (B, G, M)
    drop = torch.arange(num_group, device=points.device)[None, :, None] < num_drop
    new_idx = torch.where(drop, group_idx[:, -1:, :].expand_as(group_idx), group_idx)
    return take_points(points, new_idx.reshape(B, -1)[:, :N])


def separate_point_cloud(xyz: torch.Tensor, num_points: int, crop: int,
                         gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split each (B, N, 3) cloud into (the points without its crop, the
    ``crop`` points nearest a random direction), the direction a normal
    draw of ``gen`` (on the clouds' device) for each cloud; ``num_points``
    is the reference's argument and unused, as in JAX."""
    direction = torch.randn(xyz.shape[0], 1, 3, generator=gen, device=xyz.device,
                            dtype=xyz.dtype)
    return crop_by_direction(xyz, direction, crop)


def crop_by_direction(xyz: torch.Tensor, direction: torch.Tensor, crop: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The core of ``separate_point_cloud`` (``act_tpu/utils/misc.py:125-145``,
    reference ``seprate_point_cloud``, misc.py:157-210): ``direction`` (B, 1,
    3) scaled to unit length, each point ranked by its squared distance to it
    (a stable sort), the nearest ``crop`` the cropped part, the rest the
    input. Returns (input (B, N - crop, 3), cropped (B, crop, 3))."""
    direction = direction / (torch.sqrt((direction * direction).sum(-1, keepdim=True)) + 1e-8)
    diff = xyz - direction
    sq = diff * diff
    dist = sq[..., 0] + sq[..., 1] + sq[..., 2]
    order = torch.argsort(dist, dim=-1, stable=True)
    return take_points(xyz, order[:, crop:]), take_points(xyz, order[:, :crop])


def summary_parameters(model: nn.Module, logger=None) -> Tuple[int, int]:
    """Log a row for each parameter (name, shape, count, train or frozen by
    its ``requires_grad``) and the totals with the TuningRatio, as
    ``act_tpu/utils/misc.py:171-197`` (reference misc.py:277-307) does for
    the JAX model's params: the folded conv biases (``FOLDED_BIASES`` of the
    group encoder and the FoldingNet: zero and never trained, which the JAX
    package folds away) are left out. Returns (total, trainable)."""
    from act_tpu_torch.utils.logger import print_log
    folded = {f"{prefix}.{n}" if prefix else n for prefix, m in model.named_modules()
              for n in getattr(m, "FOLDED_BIASES", ())}
    total = trained = 0
    for name, p in model.named_parameters():
        if name in folded:
            continue
        n = p.numel()
        total += n
        trained += n if p.requires_grad else 0
        print_log(f"  {name:<70s} {str(tuple(p.shape)):>18s} {n:>12,d} "
                  f"{'train' if p.requires_grad else 'frozen'}", logger=logger)
    ratio = 100.0 * trained / max(total, 1)
    print_log(f"Total parameters: {total:,d} | trainable: {trained:,d} "
              f"| TuningRatio: {ratio:.2f}%", logger=logger)
    return total, trained
