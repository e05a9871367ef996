"""Farthest-point sampling: the CUDA kernel ``csrc/fps.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/fps.py``. The greedy walk of one cloud runs on a
thread-block cluster of 1-8 blocks that exchange their warps' candidates
through distributed shared memory, one wait a step; ``launch_geometry`` picks
the cluster size, threads and points a thread. See the note at the top of the
source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import furthest_point_sample_ref

MAX_POINTS = 16 * 1024  # the cloud in a block's shared memory; 16 points a thread
MAX_PPT = 16
# Points a block's slice keeps at least before a cloud is split further: below
# it the cluster's exchange costs more than the smaller slice saves.
MIN_SLICE = 1024


def launch_geometry(B: int, N: int, sms: int,
                    max_clusters: Callable[[int, int, int, int], int]
                    ) -> Tuple[int, int, int]:
    """(cluster size C, threads a block, points a thread) of the FPS launch.

    C is the largest of 8, 4, 2 such that the B*C blocks fit the card's
    ``sms`` SMs, each block keeps at least ``MIN_SLICE`` points, and
    ``max_clusters(N, C, threads, ppt)`` (the card's
    ``cudaOccupancyMaxActiveClusters``) runs all B clusters at once; else 1.
    (A cluster sits in one GPC: on an H100 only 30 clusters of 4 fit one
    block a SM, so at B=32 two SMs hold two blocks each; smaller clusters
    that avoid it take longer a step, see PERF.md.)
    A block's slice of ceil(N / C) points goes ``ppt`` a thread, the smallest
    power of two that keeps the block within 128 threads (slices up to 1024
    points) or 256 threads (larger slices), at most 16 (up to 1024 threads
    at N = 16384). ``python -m act_tpu_torch.kernel_sweep`` times the
    alternatives on the card."""
    for c in (8, 4, 2, 1):
        slice_ = -(-N // c)
        if c > 1 and (B * c > sms or slice_ < MIN_SLICE):
            continue
        target = 128 if slice_ <= 1024 else 256
        ppt = 1
        while ppt < MAX_PPT and ppt * target < slice_:
            ppt *= 2
        threads = -(-slice_ // ppt)
        threads = max(32, -(-threads // 32) * 32)
        if c == 1 or max_clusters(N, c, threads, ppt) >= B:
            return c, threads, ppt
    raise AssertionError("unreachable: C = 1 always fits")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(N: int, c: int, threads: int, ppt: int) -> int:
    fn = _backend.library("fps").act_fps_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return fn(N, c, threads, ppt)


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
    return torch.ops.act_tpu_torch.fps(points, start, n_samples)


@_backend.custom_op("fps")
def _fps_op(points: torch.Tensor, start: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The registered op ``act_tpu_torch::fps``: the kernel's launch on the
    card (the plain version on the CPU), (B,) int32 starts."""
    B, N, _ = points.shape
    out = torch.empty(B, n_samples, dtype=torch.int32, device=points.device)
    if B:
        dev = points.device.index
        c, threads, ppt = launch_geometry(
            B, N, _sms(torch.cuda.current_device() if dev is None else dev), _max_clusters)
        _backend.launch("fps", points, start, out, B, N, n_samples, c, threads, ppt)
    return out


_backend.register_op(
    _fps_op, lambda points, start, n_samples: furthest_point_sample_ref(points, n_samples, start),
    lambda points, start, n_samples: points.new_empty(points.shape[0], n_samples,
                                                      dtype=torch.int32))


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
