"""Collectives over the data indices of a run.

Counterpart of ``act_tpu/parallel/collectives.py`` (reference
utils/dist_utils.py): ``reduce_mean_scalar`` (all-reduce SUM / D) and
``gather_concat`` (all-gather, concatenated along the batch in data-index
order, as ``process_allgather`` concatenates) take host values over a gloo
group whatever the default backend, so they never stall the card's stream.
The JAX package needs no more: ``jit`` over the mesh reduces the gradients.
The port adds the device side: ``all_reduce_mean`` of the gradients,
``broadcast_module`` of the start weights, ``all_reduce_sum`` for the
global BatchNorm statistics and loss denominators, and ``all_gather_cat``
for the global batch of a tensor (PointBERT's mixup partners, replacement
tokens and MoCo keys), over NCCL on the card or gloo, which takes CUDA
tensors for all-reduce and broadcast.

Every one of them goes over this rank's data group (``mesh.data_group``):
the ranks that hold the same shard of the weights and different rows of
the batch. Without a tensor-parallel grid that is every rank; model peers
hold the same rows and take no part in each other's data collectives.
Each is the identity with a single data index.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from act_tpu_torch.parallel import mesh


def _no_data_peers() -> bool:
    """True without a process group, or on a TP grid of one data index (a
    group of one rank, at T = 1, still takes its collectives, as before)."""
    return not mesh.is_distributed() or (mesh.model_count() > 1 and mesh.data_count() == 1)


def reduce_mean_scalar(value: float) -> float:
    """The mean of a python scalar over the data indices."""
    if not mesh.is_distributed():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.data_cpu_group())
    return float(t[0]) / mesh.data_count()


def gather_concat(array: np.ndarray) -> np.ndarray:
    """Every data index's array concatenated along axis 0 in its order. Numeric
    arrays go as tensors (first dims may differ); others (taxonomy strings)
    as pickled objects."""
    array = np.asarray(array)
    if not mesh.is_distributed():
        return array
    if array.dtype.kind not in "biuf":
        return np.concatenate(all_gather_objects(array), axis=0)
    group, R = mesh.data_cpu_group(), mesh.data_count()
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


def gather_in_index_order(loader, *columns) -> List[np.ndarray]:
    """Every data index's per-sample rows of an unshuffled ``DataLoader``
    over the D data indices (``num_replicas=D``), without its padded
    repeats, in the order of the loader's index space (data index r's j-th
    sample is position j*D + r): what
    one process computes over the same samples. Each column holds one entry a
    sample, in this rank's order; only its first ``loader.num_real()``
    entries are real. Without a process group, each column as an array."""
    if not mesh.is_distributed():
        return [np.asarray(c) for c in columns]
    R, r = mesh.data_count(), mesh.data_index()
    keep = min(len(columns[0]), loader.num_real())
    order = np.argsort(gather_concat(np.arange(keep, dtype=np.int64) * R + r), kind="stable")
    return [gather_concat(np.asarray(c)[:keep])[order] for c in columns]


def all_gather_objects(obj) -> List:
    """Every data index's picklable ``obj`` in its order (``[obj]`` alone)."""
    if not mesh.is_distributed():
        return [obj]
    out: List = [None] * mesh.data_count()
    dist.all_gather_object(out, obj, group=mesh.data_cpu_group())
    return out


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every data index's ``t`` (the same shape on each) concatenated along
    dim 0 in data-index order, on ``t``'s device, without gradient: the
    global batch of a per-rank tensor of data (``t`` alone without a group).
    Sent as its bytes (gloo takes no bf16); under gloo through host
    memory."""
    if not mesh.is_distributed():
        return t
    src = t.detach().contiguous()
    if dist.get_backend() == "gloo":
        src = src.cpu()
    raw = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.data_count())]
    dist.all_gather(parts, raw, group=mesh.data_group())
    out = torch.cat(parts).view(t.dtype).reshape(-1, *t.shape[1:])
    return out.to(t.device)


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Each tensor in place to its mean over the data indices: one flattened
    bucket a dtype, all-reduced (SUM), divided by D, and copied back by one
    multi-tensor copy. Nothing to do with one data index."""
    if _no_data_peers():
        return
    R = mesh.data_count()
    for group in _buckets(tensors).values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat, group=mesh.data_group())
        flat.div_(R)
        torch._foreach_copy_(group, _unflatten_dense_tensors(flat, group))


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s, one
    flattened bucket a dtype, sent as its bytes (gloo takes no bf16). A
    module sharded over the model groups (``tp.shard_module``) takes its
    data group's first rank's instead: that rank holds the same shard."""
    sharded = getattr(module, "model_parallel", 1) > 1
    if not mesh.is_distributed() or (sharded and _no_data_peers()):
        return
    group = None
    if sharded:
        group, src = mesh.data_group(), mesh.data_src()
    tensors = list(module.parameters()) + list(module.buffers())
    for bucket in _buckets(tensors).values():
        flat = _flatten_dense_tensors([t.detach() for t in bucket])
        dist.broadcast(flat.view(torch.uint8), src, group=group)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


class _AllReduceSum(torch.autograd.Function):
    """SUM over the data indices forward and backward: the gradient of a sum
    that every rank's loss reads is the sum of the ranks' gradients (what
    ``torch.distributed.nn.functional.all_reduce`` does, without its
    deprecation)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, group=mesh.data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh.data_group())
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data indices, differentiable: its backward
    sums the ranks' gradients."""
    if _no_data_peers():
        return t
    return _AllReduceSum.apply(t)
