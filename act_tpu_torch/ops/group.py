"""The grouping front end: FPS centers -> kNN neighbourhoods -> center-normalized
groups, and the finetune resample.

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
from act_tpu_torch.parallel.mesh import rand_local


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


def graph_feature_idx(coor_k: torch.Tensor, coor_q: torch.Tensor, k: int = 4
                      ) -> torch.Tensor:
    """DGCNN neighbour indices: (B, Nk, 3) keys, (B, Nq, 3) queries -> (B, Nq,
    k) int32, the k nearest keys of each query, nearest first, ties to the
    smaller index (``act_tpu/ops/group.py:92-117``)."""
    return knn(coor_k, coor_q, k)[1]


def fps_subsample_by(xyz: torch.Tensor, n_fps: int, sub: torch.Tensor) -> torch.Tensor:
    """FPS to ``min(n_fps, N)`` points, then the (B, n_out) int32 positions
    ``sub`` among them, gathered once: xyz (B, N, 3) -> (B, n_out, 3).

    The FPS picks and ``sub`` are composed into one index by the gather
    kernel, the int32 picks carried through it as f32 bits (a gather moves
    bits, so every index survives, denormal or not), then the cloud is
    gathered by that index (``act_tpu/ops/group.py:120-149``). When
    ``n_fps >= N`` FPS would only reorder the cloud, so ``sub`` indexes the
    cloud itself."""
    xyz = xyz.contiguous()
    if min(n_fps, xyz.shape[1]) == xyz.shape[1]:
        return gather_coords(xyz, sub)
    picks = furthest_point_sample(xyz, n_fps)
    final = gather_coords(picks.view(torch.float32)[:, :, None], sub)
    return gather_coords(xyz, final[:, :, 0].view(torch.int32).contiguous())


def subset_draw(B: int, n_fps: int, n_out: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """A random ``n_out``-subset of ``range(n_fps)`` in random order for each
    of B clouds: (B, n_out) int32 (the first n_out of a random permutation)."""
    u = rand_local((B, n_fps), generator, device=device)
    return u.argsort(dim=-1)[:, :n_out].to(torch.int32).contiguous()


def fps_subsample(xyz: torch.Tensor, n_fps: int, n_out: int,
                  generator: torch.Generator) -> torch.Tensor:
    """The finetune resample (reference tools/runner_finetune.py:141-157):
    FPS to ``n_fps`` points, then a random ``n_out`` of them in random
    order, drawn from ``generator``. xyz (B, N, 3) -> (B, n_out, 3)."""
    B, N = xyz.shape[:2]
    sub = subset_draw(B, min(n_fps, N), n_out, generator, xyz.device)
    return fps_subsample_by(xyz, n_fps, sub)
