"""Plain PyTorch versions of the irregular point-cloud ops.

Counterpart of ``act_tpu/ops/reference.py``. These are the CPU path of every
kernel wrapper and the oracle each CUDA kernel is held against on the card.
They give the same values, indices and tie-breaks as the JAX references: FPS
starts at index 0 (or a per-cloud start) and takes the first argmax; the
k smallest come back ascending with ties to the smaller index.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def gather_rows_bwd_ref(grad: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The backward of a row gather, summed in a fixed order: grad (B, M, C),
    idx (B, M) int -> (B, rows, C) with out[b, s] the sum over m ascending
    with idx[b, m] == s of grad[b, m], accumulated in f32 from +0 and rounded
    once to grad's dtype; an index outside [0, rows) adds nothing. The plain
    version of ``csrc/rows.cu`` (the same sum in the same order, on any
    device); in f32 on the CPU it equals ``torch.gather``'s and
    ``index_select``'s own backward bit for bit. A stable sort lists each
    destination's sources in ascending order, and slot j of every list is
    added at once (a destination with fewer sources adds +0, which leaves a
    sum that starts at +0 unchanged)."""
    B, M, C = grad.shape
    dev = grad.device
    idx = idx.long()
    dest = torch.where((idx >= 0) & (idx < rows),
                       idx + rows * torch.arange(B, device=dev)[:, None], B * rows).reshape(-1)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=B * rows + 1)[:B * rows]
    starts = torch.cumsum(counts, 0) - counts
    g = grad.reshape(B * M, C)
    out = torch.zeros(B * rows, C, dtype=torch.float32, device=dev)
    for j in range(int(counts.max()) if counts.numel() else 0):
        src = order[torch.clamp(starts + j, max=B * M - 1)]
        out += torch.where((counts > j)[:, None], g[src].float(), 0.0)
    return out.reshape(B, rows, C).to(grad.dtype)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, S, C), idx (B, M) int -> (B, M, C): the rows of each cloud's
    table at its indices (exact copies)."""
    return torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, table.shape[-1]))


class RowIndex:
    """The indices (B, M) int32 of row gathers from tables of ``rows`` rows a
    cloud, shared by the gathers that use the same ones (the DGCNN's four
    rounds). ``csr`` is the backward kernel's list of each row's sources
    (``ops/rows.py``): made by its first launch on these indices on the
    card, read by the later ones; the plain version needs none."""

    def __init__(self, idx: torch.Tensor, rows: int):
        self.idx = idx
        self.rows = int(rows)
        self.csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def row_index(idx: torch.Tensor, rows: int) -> RowIndex:
    """A :class:`RowIndex` of ``idx`` (B, M) of any integer type."""
    return RowIndex(idx.to(torch.int32).contiguous(), rows)


class RowGather(torch.autograd.Function):
    """:func:`take_rows` at a :class:`RowIndex` whose backward is
    ``bwd(grad, index)``: the kernel's wrapper (``ops/rows.py``) or
    :func:`row_index_bwd_ref`."""

    @staticmethod
    def forward(ctx, table, index, bwd):
        if table.shape[1] != index.rows:
            raise ValueError(f"a RowIndex into {index.rows} rows, a table of {table.shape[1]}")
        ctx.index, ctx.bwd = index, bwd
        return take_rows(table, index.idx)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad.contiguous(), ctx.index), None, None


def row_index_bwd_ref(grad: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """:func:`gather_rows_bwd_ref` at a :class:`RowIndex`."""
    return gather_rows_bwd_ref(grad, index.idx, index.rows)


def gather_rows_ref(table: torch.Tensor, idx) -> torch.Tensor:
    """:func:`take_rows`, its backward :func:`gather_rows_bwd_ref` (the plain
    version of ``ops.gather_rows``); ``idx`` (B, M) or a :class:`RowIndex`.
    Without a gradient to take it is :func:`take_rows` alone."""
    index = idx if isinstance(idx, RowIndex) else row_index(idx, table.shape[1])
    if torch.is_grad_enabled() and table.requires_grad:
        return RowGather.apply(table, index, row_index_bwd_ref)
    return take_rows(table, index.idx)


def nn_blend(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feats: torch.Tensor,
             idx: torch.Tensor, gather_rows: Callable = gather_rows_ref) -> torch.Tensor:
    """The inverse-distance blend of the known features at the neighbour
    indices ``idx`` (B, N, k): weights ``1 / (d + 1e-8)`` normalised over k,
    d the squared distances recomputed from ``idx`` in the difference form
    ``sum((x - y)**2)`` (as ``act_tpu/ops/interpolate.py:42-50``), so that
    autograd reaches both coordinate arguments and a query on a center gets
    an exact 0; the sum of the k gathered feature rows runs in f32 and comes
    out in ``known_feats``' dtype. Each neighbour's rows come from
    ``gather_rows`` (whose backward sums in a fixed order: the plain
    :func:`gather_rows_ref`, or ``ops.gather_rows`` with the kernel's).
    (B, N, 3), (B, S, 3), (B, S, C) -> (B, N, C)."""
    B, N, k = idx.shape
    C = known_feats.shape[-1]
    d = ((unknown_xyz[:, :, None, :] - gather_points(known_xyz, idx)) ** 2).sum(-1)
    w = 1.0 / (d + 1e-8)
    w = w / w.sum(-1, keepdim=True)  # (B, N, k) f32
    out = None
    for j in range(k):  # one gathered (B, N, C) feature row set at a time
        term = gather_rows(known_feats, idx[:, :, j]).float() * w[:, :, j, None]
        out = term if out is None else out + term
    return out.to(known_feats.dtype)


def three_nn_interpolate_ref(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                             known_feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """``ops.three_nn_interpolate`` from the plain versions alone
    (``act_tpu/ops/reference.py:126``): the k nearest known points from
    ``knn_ref``, then ``nn_blend``. unknown_xyz (B, N, 3), known_xyz (B, S, 3),
    known_feats (B, S, C) -> (B, N, C)."""
    _, idx = knn_ref(known_xyz.detach(), unknown_xyz.detach(), k)
    return nn_blend(unknown_xyz, known_xyz, known_feats, idx)


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
    dy = v2 - scatter_add(i1, v1), each scatter-add the ascending sum of
    :func:`gather_rows_bwd_ref` (on the CPU ``index_add_``'s, on the card the
    same, where ``index_add_`` adds in a changing order). The plain version
    of ``chamfer_bwd``."""
    B, N, _ = x.shape
    M = y.shape[1]
    v1 = 2.0 * (x - gather_points(y, i1)) * g1[:, :, None]
    v2 = 2.0 * (y - gather_points(x, i2)) * g2[:, :, None]
    return v1 - gather_rows_bwd_ref(v2, i2, N), v2 - gather_rows_bwd_ref(v1, i1, M)
