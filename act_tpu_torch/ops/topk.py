"""Per-row k smallest: the CUDA kernel ``csrc/topk.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/topk.py``. One warp a row finds the k-th smallest
key by radix select, keeps the keys below it and the first ties at it, and
sorts those k; see the note at the top of the source.
"""
from __future__ import annotations

from typing import Tuple

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import k_smallest_ref

MAX_N = 2 ** 31 - 32  # int32 indices; a row too long for shared memory is read from L2


def k_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest of ``d`` (..., N) -> (values, int32 indices)
    (..., k), ascending, ties to the smaller index; NaNs rank above +inf, in
    index order, as in a stable ascending sort."""
    n = d.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, N={n}], got {k}")
    if d.device.type == "cpu":
        return k_smallest_ref(d, k)
    _backend.check_cuda_input(d, "k_smallest d", torch.float32)
    if n > MAX_N:
        raise ValueError(f"the k-smallest kernel takes N <= {MAX_N}, got {n}")
    return torch.ops.act_tpu_torch.k_smallest(d, k)


@_backend.custom_op("k_smallest")
def _k_smallest_op(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The registered op ``act_tpu_torch::k_smallest``: the kernel's launch
    on the card (the plain version on the CPU)."""
    n = d.shape[-1]
    lead = d.shape[:-1]
    rows = d.numel() // n
    vals = torch.empty(*lead, k, dtype=torch.float32, device=d.device)
    idxs = torch.empty(*lead, k, dtype=torch.int32, device=d.device)
    if rows:
        _backend.launch("k_smallest", d, vals, idxs, rows, n, k)
    return vals, idxs


_backend.register_op(
    _k_smallest_op, lambda d, k: tuple(t.contiguous() for t in k_smallest_ref(d, k)),
    lambda d, k: (d.new_empty(*d.shape[:-1], k),
                  d.new_empty(*d.shape[:-1], k, dtype=torch.int32)))
