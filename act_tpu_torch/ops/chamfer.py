"""Chamfer distance: the CUDA kernels of ``csrc/chamfer.cu``, their wrappers,
the autograd function and the losses.

Counterpart of ``act_tpu/ops/chamfer.py``. The JAX package takes its Pallas
kernels only above 2^21 pairs and a dense XLA form below; that size switch is
a TPU tuning choice. Here, as with every kernel of the port, the tensor's
device alone decides: on the card the recon loss's thousands of group-sized
problems and the whole-cloud metrics all launch the kernels, and the CPU takes
the plain versions. The function is the same either way: direct-form squared
distances, the same minima, the first index on ties.

Under grad, :func:`chamfer_distances` launches ``chamfer_nn`` and saves the
indices; its backward launches ``chamfer_bwd``. When nothing takes a gradient
it launches the distance-only ``chamfer_nn_min`` and saves nothing, as the
JAX ``custom_vjp`` splits its primal from ``_chamfer_fwd``
(``chamfer.py:312-324``). Both forwards compute each distance once and take
its row and column minima from tiles of the distance matrix;
:func:`launch_geometry` picks the tiling (see the note at the top of the
source).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from act_tpu_torch.ops import _backend, work
from act_tpu_torch.ops.fps import _sms
from act_tpu_torch.ops.reference import chamfer_bwd_ref, chamfer_min_ref, chamfer_ref

SHARED_LIMIT = 48 * 1024  # a block's default shared memory: no opt-in attribute
MAX_THREADS = 256
# clouds of at most this many points take chamfer_bwd's group body, which
# equals the plain version run on the CPU bit for bit (csrc/chamfer.cu)
BWD_GROUP_MAX = 32
BWD_CASES = ("one target", "n=1", "m=1", "n=m=1", "ragged", "signed zeros, mixed magnitudes",
             "out of range")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shared_bytes(tq: int, tt: int, r: int, threads: int, pack: int) -> int:
    """Shared memory of a forward launch with ``chamfer_nn``'s 8-byte keys
    (``chamfer_nn_min``'s are 4): the staged points of y and their column
    minima, and each warp's row minima (a tile's warps split its points of y
    only when the block holds one tile)."""
    wpc = threads // 32 if pack == 1 else 1
    return pack * tt * (16 + 8) + pack * wpc * tq * 8


def lanes(tq: int, r: int, threads: int, pack: int) -> Tuple[int, int]:
    """(w, wq) of a tiling: the lanes on one tile, 32 / w tiles a warp (one
    tile over all warps when pack is 1, else pack / warps tiles a warp), and
    those across its points of x; w / wq lanes go across its points of y."""
    return (32 if pack == 1 else threads // pack), tq // r


def launch_geometry(B: int, N: int, M: int, sms: int) -> Tuple[int, int, int, int, int]:
    """(tq, tt, r, threads, pack) of a Chamfer forward launch on a card of
    ``sms`` SMs: a tile is tq points of x by tt points of y, a lane holds r
    points of x, and a block of ``threads`` takes ``pack`` tiles (see
    :func:`lanes` for how the lanes share a tile).

    Clouds of at most 32 points of x and 512 of y whose tile fits the shared
    memory go whole: tq the next power of two of N, r = tq / 2 within
    [1, 8], and w = max(tq / r, min(16, tq)) lanes on a tile; the block is
    the largest of 256, 128, 64, 32 threads that gives every SM two blocks,
    else the smallest that fits. Other clouds take r = min(8, the next power
    of two of N), the first tq of 32 r, 16 r, 8 r, 4 r (below 2 N) and tt of
    512, 256, 128, 64 (at most M) whose tiles give every SM two blocks (else
    tq = 4 r, tt = 64), one tile a block and one warp for each 32 of its
    points of y, at most 256 threads.
    ``python -m act_tpu_torch.kernel_sweep`` times the alternatives."""
    if N <= 32 and M <= 512:
        tq = 1 << (N - 1).bit_length()
        r = max(1, min(8, tq // 2))
        w = max(tq // r, min(16, tq))
        fits = [t for t in (MAX_THREADS, 128, 64, 32)
                if shared_bytes(tq, M, r, t, t // w) <= SHARED_LIMIT]
        if fits:
            t = next((t for t in fits if _cdiv(B, t // w) >= 2 * sms), fits[-1])
            return tq, M, r, t, t // w
    r = min(8, 1 << (N - 1).bit_length())
    tq, tt = 4 * r, 64
    for tq_, tt_ in ((q, t) for q in (32 * r, 16 * r, 8 * r, 4 * r) for t in (512, 256, 128, 64)):
        if (tq_ < 2 * N or tq_ == 4 * r) and B * _cdiv(N, tq_) * _cdiv(M, tt_) >= 2 * sms:
            tq, tt = tq_, tt_
            break
    tt = min(tt, M)
    return tq, tt, r, min(MAX_THREADS, 32 * _cdiv(tt, 32)), 1


def _check_clouds(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 or y.shape[-1] != 3:
        raise ValueError(f"clouds must be (B, N, 3) and (B, M, 3), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.shape[0] != y.shape[0] or x.shape[1] < 1 or y.shape[1] < 1:
        raise ValueError(f"clouds need one batch size and a point each, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")


def nn_pair(x: torch.Tensor, y: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, N, 3), y (B, M, 3) -> (d1 (B, N), d2 (B, M), i1 (B, N) int32,
    i2 (B, M) int32); the kernel takes f32."""
    _check_clouds(x, y)
    work.record("chamfer_nn", *x.shape[:2], y.shape[1])
    if x.device.type == "cpu":
        return chamfer_ref(x, y)
    _backend.check_cuda_input(x, "chamfer x", torch.float32)
    _backend.check_cuda_input(y, "chamfer y", torch.float32)
    (B, N, _), M = x.shape, y.shape[1]
    d1, d2 = x.new_empty(B, N), x.new_empty(B, M)
    i1 = torch.empty(B, N, dtype=torch.int32, device=x.device)
    i2 = torch.empty(B, M, dtype=torch.int32, device=x.device)
    if B:
        geo = launch_geometry(B, N, M, _sms(x.device.index))
        # the merge keys of the directions that span several tiles
        keys = (torch.empty(B * (N + M), dtype=torch.int64, device=x.device)
                if N > geo[0] or M > geo[1] else 0)
        _backend.launch("chamfer_nn", x, y, d1, i1, d2, i2, keys, B, N, M, *geo)
    return d1, d2, i1, i2


def nn_pair_min(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distances of :func:`nn_pair` alone: (d1 (B, N), d2 (B, M))."""
    _check_clouds(x, y)
    work.record("chamfer_nn_min", *x.shape[:2], y.shape[1])
    if x.device.type == "cpu":
        return chamfer_min_ref(x, y)
    _backend.check_cuda_input(x, "chamfer x", torch.float32)
    _backend.check_cuda_input(y, "chamfer y", torch.float32)
    (B, N, _), M = x.shape, y.shape[1]
    out = x.new_empty(B * (N + M))  # one buffer: one memset readies both for the merge
    d1, d2 = out[:B * N].view(B, N), out[B * N:].view(B, M)
    if B:
        geo = launch_geometry(B, N, M, _sms(x.device.index))
        _backend.launch("chamfer_nn_min", x, y, d1, d2, B, N, M, *geo)
    return d1, d2


def chamfer_bwd(x: torch.Tensor, y: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
                g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dy) of (d1, d2) from the saved indices and the
    output gradients g1 (B, N), g2 (B, M); the kernel takes f32 and int32.

    On the card, clouds of at most ``BWD_GROUP_MAX`` points give the plain
    version's values on the CPU bit for bit; larger ones agree to rounding.
    An index outside the partner cloud makes that point's gradient NaN."""
    _check_clouds(x, y)
    if not (i1.shape == g1.shape == x.shape[:2] and i2.shape == g2.shape == y.shape[:2]):
        raise ValueError(f"chamfer_bwd: i1, g1 must be {tuple(x.shape[:2])} and i2, g2 "
                         f"{tuple(y.shape[:2])}, got {tuple(i1.shape)}, {tuple(g1.shape)}, "
                         f"{tuple(i2.shape)}, {tuple(g2.shape)}")
    work.record("chamfer_bwd", *x.shape[:2], y.shape[1])
    if x.device.type == "cpu":
        return chamfer_bwd_ref(x, y, i1, i2, g1, g2)
    for t, what, dt in ((x, "x", torch.float32), (y, "y", torch.float32),
                        (i1, "i1", torch.int32), (i2, "i2", torch.int32),
                        (g1, "g1", torch.float32), (g2, "g2", torch.float32)):
        _backend.check_cuda_input(t, f"chamfer_bwd {what}", dt)
    (B, N, _), M = x.shape, y.shape[1]
    dx, dy = torch.empty_like(x), torch.empty_like(y)  # the kernel writes every element
    _backend.launch("chamfer_bwd", x, y, i1, i2, g1, g2, dx, dy, B, N, M)
    return dx, dy


def bwd_case(name: str) -> Tuple[List[torch.Tensor], Optional[tuple]]:
    """A hard case of the backward's group body, 50 cloud pairs on the CPU:
    ((x, y, i1, i2, g1, g2), the (cloud, point) of x and of y whose index is
    out of range, or None). ``name`` is one of ``BWD_CASES``: every source
    of both clouds on one point; one-point clouds; a ragged (B, 7) x (B, 29)
    pair; output gradients of -0 and of magnitudes 1e-8 to 1e8, the sources
    of y on three points of x; an index past the end of y and one below 0.
    Other cases use the nearest-neighbour indices of random clouds."""
    gen = torch.Generator().manual_seed(BWD_CASES.index(name))
    B = 50
    N, M = {"n=1": (1, 32), "m=1": (32, 1), "n=m=1": (1, 1), "ragged": (7, 29)}.get(name, (32, 32))
    x, y = torch.randn(B, N, 3, generator=gen), torch.randn(B, M, 3, generator=gen)
    _, _, i1, i2 = chamfer_ref(x, y)
    g1, g2 = torch.randn(B, N, generator=gen), torch.randn(B, M, generator=gen)
    bad = None
    if name == "one target":
        i1, i2 = torch.full_like(i1, 5), torch.zeros_like(i2)
    elif name == "signed zeros, mixed magnitudes":
        g1 = g1 * 10.0 ** torch.randint(-8, 9, g1.shape, generator=gen).float()
        g2 = g2 * 10.0 ** torch.randint(-8, 9, g2.shape, generator=gen).float()
        g1[:, ::3], g2[:, 1::3] = -0.0, -0.0
        i2 = torch.randint(0, 3, i2.shape, generator=gen, dtype=torch.int32)
    elif name == "out of range":
        i1[3, 4], i2[7, 0] = M, -1
        bad = ((3, 4), (7, 0))
    return [x, y, i1, i2, g1, g2], bad


def check_bwd_case(name: str, fn: Callable) -> bool:
    """Whether ``fn`` (CPU inputs -> CPU (dx, dy)) gives case ``name`` of
    :func:`bwd_case` as the plain version does on the CPU, bit for bit and
    signs of zeros included. An index out of range must make its own row
    NaN and add nothing elsewhere; the plain version cannot take it, so the
    other rows are held to it with that point's gradient 0 at index 0 (a
    zero adds nothing to a sum that starts at +0)."""
    args, bad = bwd_case(name)
    got = [t.clone() for t in fn(*args)]
    if bad is not None:
        (bx, px), (by, py) = bad
        if not (torch.isnan(got[0][bx, px]).all() and torch.isnan(got[1][by, py]).all()):
            return False
        args[2][bx, px] = args[3][by, py] = 0
        args[4][bx, px] = args[5][by, py] = 0.0
        got[0][bx, px], got[1][by, py] = 0.0, 0.0
    want = list(chamfer_bwd_ref(*args))
    if bad is not None:
        want[0][bx, px], want[1][by, py] = 0.0, 0.0
    return all(torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
               for a, b in zip(got, want))


class _Chamfer(torch.autograd.Function):
    """(d1, d2) with the indexed forward and the backward of the module's
    ``nn_pair`` and ``chamfer_bwd``."""

    @staticmethod
    def forward(ctx, x, y):
        d1, d2, i1, i2 = nn_pair(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):  # an unused output's gradient arrives as zeros
        x, y, i1, i2 = ctx.saved_tensors
        return chamfer_bwd(x, y, i1, i2, g1.contiguous(), g2.contiguous())


def chamfer_distances(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, 3), y (B, M, 3) -> (dist1 (B, N), dist2 (B, M)), squared
    distances to the nearest point of the other cloud.

    Under grad (grad mode on and x or y requiring it) the indexed forward
    runs and its indices are saved for the backward; otherwise the
    distance-only forward runs and nothing is saved."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _Chamfer.apply(x, y)
    return nn_pair_min(x, y)


# public losses (reference extensions/chamfer_dist/__init__.py:28-85)

def l2_from_distances(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """mean(dist1) + mean(dist2) over all points and batch rows."""
    return torch.mean(d1) + torch.mean(d2)


def l1_from_distances(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(mean(sqrt(dist1)) + mean(sqrt(dist2))) / 2, with the JAX package's
    1e-12 guard under the square root (its gradient at 0)."""
    return 0.5 * (torch.mean(torch.sqrt(d1 + 1e-12)) + torch.mean(torch.sqrt(d2 + 1e-12)))


def chamfer_distance_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return l2_from_distances(*chamfer_distances(x, y))


def chamfer_distance_l2_split(x: torch.Tensor, y: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    d1, d2 = chamfer_distances(x, y)
    return torch.mean(d1), torch.mean(d2)


def chamfer_distance_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return l1_from_distances(*chamfer_distances(x, y))
