"""Farthest-point sampling: the CUDA kernel ``csrc/fps.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/fps.py``. One thread block runs the whole greedy
walk of one cloud; see the note at the top of the source.
"""
from __future__ import annotations

from typing import Optional

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import furthest_point_sample_ref

MAX_POINTS = 16 * 1024  # 16 points a thread in registers, 1024 threads


def furthest_point_sample(points: torch.Tensor, n_samples: int,
                          start_idx: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """points: (B, N, 3) -> (B, n_samples) int32 indices.

    ``start_idx``: None (every walk starts at index 0) or an int / (B,) tensor
    of per-cloud starts in [0, N). On the card the kernel's picks equal the
    plain version's up to a swap of two adjacent picks at a one-ulp distance
    tie (same selected set)."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    B, N, _ = points.shape
    if not 1 <= n_samples <= N:
        raise ValueError(f"n_samples must be in [1, N={N}], got {n_samples}")
    if start_idx is not None:
        start_idx = torch.as_tensor(start_idx, device=points.device)
        if (start_idx.is_floating_point() or start_idx.dim() > 1
                or start_idx.numel() not in (1, B)):
            raise ValueError("start_idx must be an int or a (B,) integer tensor, "
                             f"got {start_idx.dtype} {tuple(start_idx.shape)}")
        # the kernel would clamp a start outside [0, N), the plain version
        # index out of range or wrap; on the card this check syncs
        if B and not bool(((start_idx >= 0) & (start_idx < N)).all()):
            raise ValueError(f"start_idx outside [0, {N})")
    if points.device.type == "cpu":
        return furthest_point_sample_ref(points, n_samples, start_idx)
    _backend.check_cuda_input(points, "furthest_point_sample points", torch.float32)
    if N > MAX_POINTS:
        raise ValueError(f"the FPS kernel takes N <= {MAX_POINTS}, got {N}")
    if start_idx is None:
        start = torch.zeros(B, dtype=torch.int32, device=points.device)
    else:
        start = start_idx.to(torch.int32).expand(B).contiguous()
    out = torch.empty(B, n_samples, dtype=torch.int32, device=points.device)
    if B:
        _backend.launch("fps", points, start, out, B, N, n_samples)
    return out


def tie_swaps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Number of adjacent-pick swaps between two (B, S) FPS index lists, or
    -1 if they differ otherwise. A swap is the only difference that a
    one-ulp distance tie may cause (``act_tpu/ops/fps.py:213-217``): picks s
    and s+1 exchanged, the same selected set."""
    if got.shape != want.shape:
        return -1
    got, want = got.cpu().tolist(), want.cpu().tolist()
    swaps = 0
    for g, w in zip(got, want):
        s = 0
        while s < len(g):
            if g[s] == w[s]:
                s += 1
            elif s + 1 < len(g) and g[s] == w[s + 1] and g[s + 1] == w[s]:
                swaps += 1
                s += 2
            else:
                return -1
    return swaps
