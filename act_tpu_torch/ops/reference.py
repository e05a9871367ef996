"""Plain PyTorch versions of the irregular point-cloud ops.

Counterpart of ``act_tpu/ops/reference.py``. These are the CPU path of every
kernel wrapper and the oracle each CUDA kernel is held against on the card.
They give the same values, indices and tie-breaks as the JAX references: FPS
starts at index 0 (or a per-cloud start) and takes the first argmax; the
k smallest come back ascending with ties to the smaller index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distance in the expanded form.

    src: (..., N, C), dst: (..., M, C) -> (..., N, M). On a card the product
    runs in full f32 (``resolve_device`` sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``; TF32 keeps too few bits
    for nearest-neighbour ranks)."""
    d = -2.0 * torch.matmul(src, dst.transpose(-1, -2))
    d = d + torch.sum(src ** 2, dim=-1)[..., :, None]
    d = d + torch.sum(dst ** 2, dim=-1)[..., None, :]
    return d


def furthest_point_sample_ref(points: torch.Tensor, n_samples: int,
                              start_idx: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Greedy farthest-point sampling. points: (B, N, 3) -> (B, n_samples) int32.

    ``start_idx``: None (index 0) or per-cloud (B,) start indices. Each step
    takes the first argmax of the running minimum of
    ``(x-cx)**2 + (y-cy)**2 + (z-cz)**2``."""
    B, N, _ = points.shape
    dev = points.device
    if start_idx is None:
        start = torch.zeros(B, dtype=torch.long, device=dev)
    else:
        start = torch.as_tensor(start_idx, device=dev).long().expand(B)
    rows = torch.arange(B, device=dev)
    idxs = torch.empty(B, n_samples, dtype=torch.int32, device=dev)
    idxs[:, 0] = start
    dists = torch.full((B, N), float("inf"), dtype=points.dtype, device=dev)
    last = points[rows, start]  # (B, 3)
    for i in range(1, n_samples):
        diff = points - last[:, None, :]
        d = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
        dists = torch.minimum(dists, d)
        nxt = torch.argmax(dists, dim=-1)  # first index of the max
        idxs[:, i] = nxt
        last = points[rows, nxt]
    return idxs


def k_smallest_ref(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest of ``d`` (..., N) -> (values, int32 indices) (..., k),
    ascending, ties to the smaller index. A stable ascending sort gives that
    order; ``torch.topk`` does not promise it."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def knn_ref(ref_points: torch.Tensor, query: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query in ref_points.

    ref_points: (B, N, C), query: (B, S, C) -> (squared dists, int32 idx),
    each (B, S, k)."""
    return k_smallest_ref(square_distance(query, ref_points), k)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C), idx: (B, ...) int -> (B, ..., C) gathered along N."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def group_points_ref(xyz: torch.Tensor, num_group: int, group_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.group_points`` from the plain versions alone: FPS centers, kNN,
    gather, center subtraction. xyz: (B, N, 3) -> (neighborhood (B, G, M, 3),
    center (B, G, 3))."""
    center = gather_points(xyz, furthest_point_sample_ref(xyz, num_group))
    _, idx = knn_ref(xyz, center, group_size)
    return gather_points(xyz, idx) - center[:, :, None, :], center
