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


def graph_feature_idx_ref(coor_k: torch.Tensor, coor_q: torch.Tensor, k: int = 4
                          ) -> torch.Tensor:
    """DGCNN neighbour indices from the plain versions: (B, Nk, 3) keys,
    (B, Nq, 3) queries -> (B, Nq, k) int32, nearest first, ties to the
    smaller index."""
    return knn_ref(coor_k, coor_q, k)[1]


_MASK32 = 0xFFFFFFFF


def gumbel_chunk(rows: int, v: int) -> int:
    """Rows a chunk of the JAX kernel's grid holds (``_gumbel_rows``,
    ``act_tpu/ops/sampling.py:84-88``); the hash counts rows within a chunk."""
    vpad = -(-v // 128) * 128
    chunk = max(8, min(256, (4 * 1024 * 1024) // (4 * vpad)))
    return min(chunk, -(-rows // 8) * 8)


def gumbel_perturbed_ref(logits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """f32(logits) + Gumbel noise, the noise from the counter hash of the JAX
    kernel's interpret path (``sampling.py:33-42``) in int64 masked to 32
    bits. logits (..., V), seed (2,) int32 -> (..., V) f32. Rows go in blocks
    of at most 2^22 elements to bound the int64 temporaries."""
    *lead, v = logits.shape
    x = logits.reshape(-1, v)
    rows = x.shape[0]
    chunk = gumbel_chunk(rows, v)
    s0, s1 = (int(s) for s in seed.reshape(-1)[:2].tolist())
    dev = logits.device
    lane = torch.arange(v, dtype=torch.int64, device=dev) * 40503
    out = torch.empty(rows, v, dtype=torch.float32, device=dev)
    step = max(1, (1 << 22) // v)
    for r0 in range(0, rows, step):
        row = torch.arange(r0, min(rows, r0 + step), dtype=torch.int64, device=dev)
        base = ((row % chunk) * 0x9E3779B9 + s0 * 69069 + s1 * 1013904223
                + (row // chunk) * 22695477 + 374761393)
        h = (base[:, None] + lane[None, :]) & _MASK32
        h = h ^ ((h << 13) & _MASK32)
        h = h ^ (h >> 17)
        h = h ^ ((h << 5) & _MASK32)
        u = torch.clamp_min((h >> 1).to(torch.float32) * 2.0 ** -31, 1e-10)
        out[r0:r0 + row.numel()] = x[r0:r0 + row.numel()].float() + (
            -torch.log(-torch.log(u)))
    return out.reshape(*lead, v)


def gumbel_argmax_ref(logits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """ids = argmax(logits + Gumbel noise) over the last axis, the first index
    of the maximum: (..., V) bf16/f32 + (2,) int32 seed -> (...) int32. The
    plain version of ``csrc/gumbel.cu``."""
    return torch.argmax(gumbel_perturbed_ref(logits, seed), dim=-1).to(torch.int32)


def pair_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances in the direct form ``((dx*dx + dy*dy) + dz*dz)``,
    each operation rounded on its own, as ``act_tpu/ops/chamfer.py:70-72``
    and the Chamfer kernels compute them. x (B, N, 3), y (B, M, 3) -> (B, N, M)."""
    def sq(c):
        d = x[:, :, None, c] - y[:, None, :, c]
        return d * d
    return (sq(0) + sq(1)) + sq(2)


def chamfer_ref(x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both directed nearest neighbours: x (B, N, 3), y (B, M, 3) -> (d1 (B, N),
    d2 (B, M), i1 (B, N) int32, i2 (B, M) int32), squared distances and the
    first index of each minimum (``torch.argmin``'s tie-break). The plain
    version of ``chamfer_nn``."""
    d = pair_distance(x, y)
    return (torch.amin(d, dim=2), torch.amin(d, dim=1),
            torch.argmin(d, dim=2).to(torch.int32), torch.argmin(d, dim=1).to(torch.int32))


def chamfer_min_ref(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distances of :func:`chamfer_ref` alone: (d1 (B, N), d2 (B, M)). The
    plain version of ``chamfer_nn_min``."""
    d = pair_distance(x, y)
    return torch.amin(d, dim=2), torch.amin(d, dim=1)


def chamfer_bwd_ref(x: torch.Tensor, y: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
                    g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of (d1, d2) = chamfer(x, y) from the saved indices and the
    output gradients g1 (B, N), g2 (B, M) (``_chamfer_bwd``,
    ``act_tpu/ops/chamfer.py:341-369``): v1 = 2 (x - y[i1]) g1,
    v2 = 2 (y - x[i2]) g2, dx = v1 - scatter_add(i2, v2),
    dy = v2 - scatter_add(i1, v1). The plain version of ``chamfer_bwd``."""
    B, N, _ = x.shape
    M = y.shape[1]
    v1 = 2.0 * (x - gather_points(y, i1)) * g1[:, :, None]
    v2 = 2.0 * (y - gather_points(x, i2)) * g2[:, :, None]
    rows_x = (torch.arange(B, device=x.device)[:, None] * N + i2.long()).reshape(-1)
    rows_y = (torch.arange(B, device=x.device)[:, None] * M + i1.long()).reshape(-1)
    sx = torch.zeros(B * N, 3, dtype=v2.dtype, device=x.device).index_add_(0, rows_x, v2.reshape(-1, 3))
    sy = torch.zeros(B * M, 3, dtype=v1.dtype, device=x.device).index_add_(0, rows_y, v1.reshape(-1, 3))
    return v1 - sx.reshape(B, N, 3), v2 - sy.reshape(B, M, 3)
