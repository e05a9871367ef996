"""Collectives of a data-parallel run.

Counterpart of ``act_tpu/parallel/collectives.py`` (reference
utils/dist_utils.py): ``reduce_mean_scalar`` (all-reduce SUM / world) and
``gather_concat`` (all-gather, concatenated along the batch in rank order,
as ``process_allgather`` concatenates) take host values over the gloo group
of ``mesh.cpu_group`` whatever the default backend, so they never stall the
card's stream. The JAX package needs no more: ``jit`` over the mesh reduces
the gradients. The port adds the device side: ``all_reduce_mean`` of the
gradients, ``broadcast_module`` of the start weights and ``all_reduce_sum``
for the global BatchNorm statistics, over the default group (NCCL on the
card, or gloo, which takes CUDA tensors for all-reduce and broadcast).
Each is the identity without a process group.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from act_tpu_torch.parallel import mesh


def reduce_mean_scalar(value: float) -> float:
    """The mean of a python scalar over the ranks."""
    if not mesh.is_distributed():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.cpu_group())
    return float(t[0]) / mesh.process_count()


def gather_concat(array: np.ndarray) -> np.ndarray:
    """Every rank's array concatenated along axis 0 in rank order. Numeric
    arrays go as tensors (first dims may differ); others (taxonomy strings)
    as pickled objects."""
    array = np.asarray(array)
    if not mesh.is_distributed():
        return array
    if array.dtype.kind not in "biuf":
        return np.concatenate(all_gather_objects(array), axis=0)
    group, R = mesh.cpu_group(), mesh.process_count()
    t = torch.from_numpy(np.ascontiguousarray(array))
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    ns = [torch.zeros_like(n) for _ in range(R)]
    dist.all_gather(ns, n, group=group)
    top = int(max(int(x) for x in ns))
    padded = torch.zeros((top,) + tuple(t.shape[1:]), dtype=t.dtype)
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(R)]
    dist.all_gather(parts, padded, group=group)
    return np.concatenate([p[:int(k)].numpy() for p, k in zip(parts, ns)], axis=0)


def all_gather_objects(obj) -> List:
    """Every rank's picklable ``obj`` in rank order (``[obj]`` alone)."""
    if not mesh.is_distributed():
        return [obj]
    out: List = [None] * mesh.process_count()
    dist.all_gather_object(out, obj, group=mesh.cpu_group())
    return out


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Each tensor in place to its mean over the ranks: one flattened bucket
    a dtype, all-reduced (SUM), divided by R, and copied back by one
    multi-tensor copy."""
    if not mesh.is_distributed():
        return
    R = mesh.process_count()
    for group in _buckets(tensors).values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat)
        flat.div_(R)
        torch._foreach_copy_(group, _unflatten_dense_tensors(flat, group))


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s, one
    flattened bucket a dtype, sent as its bytes (gloo takes no bf16)."""
    if not mesh.is_distributed():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for group in _buckets(tensors).values():
        flat = _flatten_dense_tensors([t.detach() for t in group])
        dist.broadcast(flat.view(torch.uint8), src)
        torch._foreach_copy_(group, _unflatten_dense_tensors(flat, group))


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks forward and backward: the gradient of a sum that
    every rank's loss reads is the sum of the ranks' gradients (what
    ``torch.distributed.nn.functional.all_reduce`` does, without its
    deprecation)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward sums the
    ranks' gradients."""
    if not mesh.is_distributed():
        return t
    return _AllReduceSum.apply(t)
