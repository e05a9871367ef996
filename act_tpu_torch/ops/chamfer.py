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
(``chamfer.py:312-324``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import chamfer_bwd_ref, chamfer_min_ref, chamfer_ref


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
    if x.device.type == "cpu":
        return chamfer_ref(x, y)
    _backend.check_cuda_input(x, "chamfer x", torch.float32)
    _backend.check_cuda_input(y, "chamfer y", torch.float32)
    (B, N, _), M = x.shape, y.shape[1]
    d1, d2 = x.new_empty(B, N), x.new_empty(B, M)
    i1 = torch.empty(B, N, dtype=torch.int32, device=x.device)
    i2 = torch.empty(B, M, dtype=torch.int32, device=x.device)
    if B:
        _backend.launch("chamfer_nn", x, y, d1, i1, d2, i2, B, N, M)
    return d1, d2, i1, i2


def nn_pair_min(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distances of :func:`nn_pair` alone: (d1 (B, N), d2 (B, M))."""
    _check_clouds(x, y)
    if x.device.type == "cpu":
        return chamfer_min_ref(x, y)
    _backend.check_cuda_input(x, "chamfer x", torch.float32)
    _backend.check_cuda_input(y, "chamfer y", torch.float32)
    (B, N, _), M = x.shape, y.shape[1]
    d1, d2 = x.new_empty(B, N), x.new_empty(B, M)
    if B:
        _backend.launch("chamfer_nn_min", x, y, d1, d2, B, N, M)
    return d1, d2


def chamfer_bwd(x: torch.Tensor, y: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
                g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dy) of (d1, d2) from the saved indices and the
    output gradients g1 (B, N), g2 (B, M); the kernel takes f32 and int32."""
    _check_clouds(x, y)
    if not (i1.shape == g1.shape == x.shape[:2] and i2.shape == g2.shape == y.shape[:2]):
        raise ValueError(f"chamfer_bwd: i1, g1 must be {tuple(x.shape[:2])} and i2, g2 "
                         f"{tuple(y.shape[:2])}, got {tuple(i1.shape)}, {tuple(g1.shape)}, "
                         f"{tuple(i2.shape)}, {tuple(g2.shape)}")
    if x.device.type == "cpu":
        return chamfer_bwd_ref(x, y, i1, i2, g1, g2)
    for t, what, dt in ((x, "x", torch.float32), (y, "y", torch.float32),
                        (i1, "i1", torch.int32), (i2, "i2", torch.int32),
                        (g1, "g1", torch.float32), (g2, "g2", torch.float32)):
        _backend.check_cuda_input(t, f"chamfer_bwd {what}", dt)
    (B, N, _), M = x.shape, y.shape[1]
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    _backend.launch("chamfer_bwd", x, y, i1, i2, g1, g2, dx, dy, B, N, M)
    return dx, dy


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
