"""Coordinate gather: the CUDA kernel ``csrc/gather.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/gather.py`` and of the dispatch in
``act_tpu/ops/reference.py::gather_coords``. On the card every coordinate
gather launches the kernel, whatever its size.
"""
from __future__ import annotations

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import gather_points

MAX_CHANNELS = 8


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
    B, N, C = points.shape
    S = idx.numel() // max(B, 1)
    out = torch.empty(*idx.shape, C, dtype=torch.float32, device=points.device)
    if out.numel():
        _backend.launch("gather", points, idx, out, B, N, S, C)
    return out
