"""The grouping front end: FPS centers -> kNN neighbourhoods -> center-normalized groups.

Counterpart of ``act_tpu/ops/group.py``. The distance matrix is a plain f32
product (JAX leaves it to XLA as well); the selection, the sampling and the
coordinate gathers are the CUDA kernels on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from act_tpu_torch.ops.fps import furthest_point_sample
from act_tpu_torch.ops.gather import gather_coords
from act_tpu_torch.ops.reference import square_distance
from act_tpu_torch.ops.topk import k_smallest


def knn(ref_points: torch.Tensor, query: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours: (B, N, C) ref, (B, S, C) query -> (squared
    dists, int32 idx) (B, S, k), ascending, ties to the smaller index."""
    return k_smallest(square_distance(query, ref_points), k)


def group_points(xyz: torch.Tensor, num_group: int, group_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz: (B, N, 3) -> (neighborhood (B, G, M, 3) center-normalized,
    center (B, G, 3)): FPS to G centers, kNN of size M around each, gather,
    subtract the center (reference ``Group.forward``, models/dvae.py:161-183)."""
    xyz = xyz.contiguous()
    center = gather_coords(xyz, furthest_point_sample(xyz, num_group))
    _, idx = knn(xyz, center, group_size)
    neighborhood = gather_coords(xyz, idx)
    return neighborhood - center[:, :, None, :], center
