"""Coordinate gather: the CUDA kernel ``csrc/gather.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/gather.py`` and of the dispatch in
``act_tpu/ops/reference.py::gather_coords``. On the card every coordinate
gather launches the kernel, whatever its size.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import gather_points

MAX_CHANNELS = 8
MAX_THREADS = 256
TILE_POINTS = 1 << 16  # gathers of at least this many points take the tile body


def launch_geometry(B: int, S: int, aligned: bool) -> Tuple[bool, int]:
    """(tile, threads) of a gather of (B, S) indices: the body of
    ``csrc/gather.cu`` and the threads a block. Gathers of at least
    ``TILE_POINTS`` points whose index and output views are 16-byte aligned
    with S a multiple of 4 (``aligned``) take the tile body (a warp 128
    points), 256 threads a block from 2^17 points, else 128; all others a
    thread an element, 256 a block. The split and the blocks are the fastest
    that ``python -m act_tpu_torch.kernel_sweep`` measured at the paths'
    shapes on the H100 (``PERF.md`` §6)."""
    if aligned and B * S >= TILE_POINTS:
        return True, MAX_THREADS if B * S >= 2 * TILE_POINTS else 128
    return False, MAX_THREADS


def gather_coords(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C <= 8) f32, idx: (B, ...) int -> (B, ..., C).

    The gathered values equal the plain ``gather_points`` bit for bit. On the
    card the indices must be int32; one outside [0, N) gathers NaN."""
    if points.dim() != 3 or points.shape[-1] > MAX_CHANNELS:
        raise ValueError(f"points must be (B, N, C<={MAX_CHANNELS}), "
                         f"got {tuple(points.shape)}")
    if idx.dim() < 1 or idx.shape[0] != points.shape[0]:
        raise ValueError(f"idx must be (B, ...) with B={points.shape[0]}, "
                         f"got {tuple(idx.shape)}")
    if points.device.type == "cpu":
        return gather_points(points, idx)
    _backend.check_cuda_input(points, "gather_coords points", torch.float32)
    _backend.check_cuda_input(idx, "gather_coords idx", torch.int32)
    return torch.ops.act_tpu_torch.gather(points, idx)


@_backend.custom_op("gather")
def _gather_op(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The registered op ``act_tpu_torch::gather``: the kernel's launch on
    the card (the plain version on the CPU)."""
    B, N, C = points.shape
    S = idx.numel() // max(B, 1)
    out = torch.empty(*idx.shape, C, dtype=torch.float32, device=points.device)
    if out.numel():
        aligned = S % 4 == 0 and idx.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        _backend.launch("gather", points, idx, out, B, N, S, C, *launch_geometry(B, S, aligned))
    return out


_backend.register_op(_gather_op, gather_points,
                     lambda points, idx: points.new_empty(*idx.shape, points.shape[-1]))


def check_gather_cases(fn: Callable, device) -> List[str]:
    """The hard cases on which ``fn`` (``gather_coords``) differs from
    ``gather_points`` bit for bit: every C in 1-8 through both bodies (small
    gathers, and gathers of 2^16 and 2^17 points with S a multiple of 4, the
    last tile of a cloud ragged or not), S not a multiple of 4 and an index
    view at an odd element offset (the element body at any size), B = 0 and
    S = 0; and whether an index outside [0, N) gathers NaN while its
    neighbours gather their rows, in both bodies."""
    gen = torch.Generator().manual_seed(5)
    wrong = []
    for C in range(1, MAX_CHANNELS + 1):
        pts = torch.randn(64, 1000, C, generator=gen).to(device)
        cases = {f"C={C} idx {s}": torch.randint(0, 1000, s, generator=gen).int().to(device)
                 for s in ((3, 50, 7), (3, 64), (3, 1001), (3, 2), (3, 1), (32, 2048),
                           (32, 2052), (32, 2050), (64, 2048))}
        base = torch.randint(0, 1000, (32 * 2048 + 1,), generator=gen).int().to(device)
        cases[f"C={C} idx at an odd offset"] = base[1:].view(32, 2048)
        cases[f"C={C} B=0"] = base[:0].view(0, 5)
        cases[f"C={C} S=0"] = base[:0].view(3, 0)
        for tag, idx in cases.items():
            p = pts[:idx.shape[0]]
            got = fn(p, idx)
            want = gather_points(p, idx) if idx.numel() else p.new_empty(*idx.shape, C)
            if got.shape != want.shape or not torch.equal(got, want):
                wrong.append(tag)
    pts = torch.randn(32, 1000, 3, generator=gen).to(device)
    for S in (4, 2048):  # the element body, the tile body
        idx = torch.randint(0, 1000, (32, S), generator=gen).int()
        idx[0, :4] = torch.tensor([0, 1000, -1, 7], dtype=torch.int32)
        out = fn(pts, idx.to(device))
        if not (torch.isnan(out[0, 1:3]).all() and torch.equal(out[0, 0], pts[0, 0])
                and torch.equal(out[0, 3], pts[0, 7])):
            wrong.append(f"out of range, S={S}")
    return wrong
