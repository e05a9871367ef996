"""Farthest-point sampling: the CUDA kernel ``csrc/fps.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/fps.py``. The greedy walk of one cloud runs on a
thread-block cluster whose blocks exchange their warps' candidates through
distributed shared memory, one wait a step. ``launch_geometry`` picks the
cluster size, threads and points a thread; :func:`fps_body` derives from
them where a block keeps its slice of the cloud: in registers up to
``REGISTER_POINTS`` points (clusters of 1-8 blocks), above that in shared
memory (clusters of 2-16), and past what a cluster of 16 holds there, in the
points themselves and a (B, N) f32 scratch of running minima that the wrapper
allocates (the streamed body). The rule lives here only: the kernel takes the
registers body up to ``REGISTER_POINTS`` points and, above, the streamed body
exactly when it is given the scratch. Any N below 2^31 runs on the card. See
the note at the top of the source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from act_tpu_torch.ops import _backend, work
from act_tpu_torch.ops.reference import furthest_point_sample_ref

REGISTER_POINTS = 16 * 1024  # the registers body's largest cloud (each block holds it whole)
MAX_PPT = 16
# Points a block's slice keeps at least before a cloud is split further: below
# it the cluster's exchange costs more than the smaller slice saves.
MIN_SLICE = 1024
# The shared and streamed bodies: cluster sizes (16 is non-portable), the
# points a thread and the largest block of the shared body, the streamed
# body's block, a record's bytes (key, x, y, z) and the dynamic shared memory
# a block may use (csrc/fps.cu's constants). A shared block's W warps send W
# records a step to every block of the cluster: at 131072 points 256 threads
# took 2.3 us a step, 1024 threads 3.6 (PERF.md); the streamed body is bound
# by its loads and takes the most threads.
BIG_CLUSTERS = (2, 4, 8, 16)
BIG_PPT, SHARED_THREADS, STREAMED_THREADS = 8, 256, 1024
REC_BYTES = 20
SMEM_LIMIT = 227 * 1024
# The card's occupancy is asked about a shared block's slice rounded up to a
# multiple of QUERY_SLICE points (at most 2 KB a block more, never past what
# fits), so its answers, cached, stay a few hundred whatever clouds a server
# is sent; a streamed block's shared memory does not depend on N at all.
QUERY_SLICE = 128


def big_smem_bytes(c: int, threads: int, slice_: int) -> int:
    """A shared-body block's dynamic shared memory (``csrc/fps.cu``
    ``big_smem_bytes``): two parities of C*W records, two mbarriers, and the
    slice's x, y, z and running minimum."""
    return 2 * c * (threads // 32) * REC_BYTES + 16 + 16 * slice_


def fps_body(N: int, c: int, threads: int) -> str:
    """Where a block keeps its slice (``csrc/fps.cu`` ``fps_body``):
    "registers", "shared" or "streamed"."""
    if N <= REGISTER_POINTS:
        return "registers"
    return "shared" if big_smem_bytes(c, threads, -(-N // c)) <= SMEM_LIMIT else "streamed"


def query_args(N: int, c: int, threads: int, ppt: int) -> tuple:
    """The arguments of the card's occupancy query (:func:`_max_clusters`)
    for a launch at (N, C, threads, ppt): as they are up to
    ``REGISTER_POINTS`` points; above, (n, C, threads, ppt, streamed) of the
    smallest cloud n > ``REGISTER_POINTS`` whose block has the same kernel and
    at least the same shared memory (the shared body's slice rounded up to
    ``QUERY_SLICE`` points, the streamed body's any)."""
    if N <= REGISTER_POINTS:
        return N, c, threads, ppt
    streamed = fps_body(N, c, threads) == "streamed"
    if streamed:
        slice_ = REGISTER_POINTS // c + 1
    else:
        fits = (SMEM_LIMIT - big_smem_bytes(c, threads, 0)) // 16
        slice_ = min(-(-N // (c * QUERY_SLICE)) * QUERY_SLICE, fits)
    return c * slice_, c, threads, -(-slice_ // threads), streamed


def launch_geometry(B: int, N: int, sms: int,
                    max_clusters: Callable[..., int]) -> Tuple[int, int, int]:
    """(cluster size C, threads a block, points a thread) of the FPS launch.

    Up to ``REGISTER_POINTS`` points (the registers body): C is the largest
    of 8, 4, 2 such that the B*C blocks fit the card's ``sms`` SMs, each
    block keeps at least ``MIN_SLICE`` points, and ``max_clusters(N, C,
    threads, ppt)`` (the card's ``cudaOccupancyMaxActiveClusters``; above
    ``REGISTER_POINTS`` it is called with :func:`query_args`) runs all B
    clusters at once; else 1.
    (A cluster sits in one GPC: on an H100 only 30 clusters of 4 fit one
    block a SM, so at B=32 two SMs hold two blocks each; smaller clusters
    that avoid it take longer a step, see PERF.md.)
    A block's slice of ceil(N / C) points goes ``ppt`` a thread, the smallest
    power of two that keeps the block within 128 threads (slices up to 1024
    points) or 256 threads (larger slices), at most 16 (up to 1024 threads
    at N = 16384).

    Above it, :func:`_big_geometry`. ``python -m act_tpu_torch.kernel_sweep``
    times the alternatives on the card."""
    if N > REGISTER_POINTS:
        return _big_geometry(B, N, sms, max_clusters)
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


def _big_geometry(B: int, N: int, sms: int,
                  max_clusters: Callable[[int, int, int, int], int]) -> Tuple[int, int, int]:
    """Above ``REGISTER_POINTS`` points. The shared body where a cluster of
    at most 16 holds the cloud, at about ``BIG_PPT`` points a thread (128 to
    ``SHARED_THREADS`` threads): the smallest such C that the card runs,
    doubled while the B*2C blocks fit the SMs and the card runs all B
    clusters of 2C at once. Past that the streamed body, ``STREAMED_THREADS``
    threads, on the largest C the card runs. Clusters beyond the card's room
    run in waves: a cloud's cluster is independent of the others'."""
    def shared_geo(c):
        slice_ = -(-N // c)
        threads = min(SHARED_THREADS, max(128, -(-slice_ // (BIG_PPT * 32)) * 32))
        return c, threads, -(-slice_ // threads)

    def room(geo):
        return max_clusters(*query_args(N, *geo))

    shared = [c for c in BIG_CLUSTERS if fps_body(N, c, shared_geo(c)[1]) == "shared"
              and room(shared_geo(c)) >= 1]
    if shared:
        c = shared[0]
        while 2 * c in shared and B * 2 * c <= sms and room(shared_geo(2 * c)) >= B:
            c *= 2
        return shared_geo(c)
    for c in reversed(BIG_CLUSTERS):
        geo = (c, STREAMED_THREADS, -(-N // (c * STREAMED_THREADS)))
        if room(geo) >= 1:
            return geo
    raise RuntimeError(f"the card runs no FPS cluster of 2-16 blocks at N={N}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(N: int, c: int, threads: int, ppt: int, streamed: bool = False) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` of a launch, taking
    :func:`query_args`; its N is at most ``REGISTER_POINTS`` or one of few."""
    fn = _backend.library("fps").act_fps_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(N, c, threads, ppt, int(streamed))


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
    if N >= 2 ** 31:
        raise ValueError(f"FPS takes N < 2^31 (int32 indices), got {N}")
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
        work.record("fps", B, N, n_samples)
        return furthest_point_sample_ref(points, n_samples, start_idx)
    _backend.check_cuda_input(points, "furthest_point_sample points", torch.float32)
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
        launch_kernel(points, start, out, launch_geometry(
            B, N, _sms(torch.cuda.current_device() if dev is None else dev), _max_clusters))
    return out


def launch_kernel(points: torch.Tensor, start: torch.Tensor, out: torch.Tensor,
                  geometry: Tuple[int, int, int]) -> None:
    """One launch of the kernel at ``geometry`` (C, threads, ppt) into
    ``out`` (B, S) int32, with the (B, N) f32 scratch of the streamed body
    allocated here (freed in stream order after the launch); the scratch is
    what makes the kernel take the streamed body."""
    B, N, _ = points.shape
    c, threads, _ = geometry
    scratch = (torch.empty(B, N, dtype=torch.float32, device=points.device)
               if fps_body(N, c, threads) == "streamed" else 0)
    _backend.launch("fps", points, start, out, scratch, B, N, out.shape[1], *geometry)


_backend.register_op(
    _fps_op, lambda points, start, n_samples: furthest_point_sample_ref(points, n_samples, start),
    lambda points, start, n_samples: points.new_empty(points.shape[0], n_samples,
                                                      dtype=torch.int32), work.fps_op)


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
