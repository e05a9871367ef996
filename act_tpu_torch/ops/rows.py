"""Row gathers whose backward sums in a fixed order: the CUDA kernel
``csrc/rows.cu`` and its wrapper.

No Pallas kernel has this counterpart. ``torch.gather`` and ``index_select``
copy rows exactly, but their backward on the card adds with atomics in an
order that changes from run to run; the DGCNN's neighbour rows
(``models/common.py``) and the 3-NN blend's feature rows
(``ops/reference.py`` ``nn_blend``) go through :func:`gather_rows` instead,
so Stage-I and segmentation steps repeat bit for bit on the card. Its
forward stays ``torch.gather``; its backward launches the kernel, which sums
each destination row's gradients in ascending source order in f32 and
rounds once, as the plain version ``reference.gather_rows_bwd_ref`` does.
"""
from __future__ import annotations

import torch

from act_tpu_torch.ops import _backend, work
from act_tpu_torch.ops.reference import (RowGather, RowIndex, gather_rows_bwd_ref, row_index,
                                         take_rows)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes
MAX_ROWS = 8192  # rows of a cloud's table (their counters in shared memory)
MAX_CLOUDS = 65535


def gather_rows_bwd(grad: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """grad (B, M, C) f32 or bf16 at the indices (B, M) of ``index`` ->
    (B, index.rows, C): each destination row the sum of its sources'
    gradient rows in ascending order, in f32, rounded once. A CPU tensor
    takes the plain version; on the card the kernel, bit-equal to it. The
    first launch at an index lists each row's sources into ``index.csr``;
    later launches at it read that list."""
    idx, rows = index.idx, index.rows
    if grad.dim() != 3 or idx.shape != grad.shape[:2]:
        raise ValueError(f"gather_rows_bwd: grad (B, M, C) and idx (B, M), got "
                         f"{tuple(grad.shape)} and {tuple(idx.shape)}")
    work.record("row_gather_bwd", *grad.shape)
    if grad.device.type == "cpu":
        return gather_rows_bwd_ref(grad, idx, rows)
    if grad.dtype not in DTYPES:
        raise ValueError(f"gather_rows_bwd: the CUDA kernel takes f32 or bf16, got {grad.dtype}")
    _backend.check_cuda_input(grad, "gather_rows_bwd grad", grad.dtype)
    _backend.check_cuda_input(idx, "gather_rows_bwd idx", torch.int32)
    B, M, C = grad.shape
    if rows > MAX_ROWS or B > MAX_CLOUDS:
        raise ValueError(f"gather_rows_bwd: at most {MAX_ROWS} rows and {MAX_CLOUDS} clouds, "
                         f"got {rows} and {B}")
    build = index.csr is None
    if build:
        index.csr = (torch.empty(B * M, dtype=torch.int32, device=grad.device),
                     torch.empty(B * (rows + 1), dtype=torch.int32, device=grad.device))
    order, starts = index.csr
    out = torch.empty(B, rows, C, dtype=grad.dtype, device=grad.device)  # every row written
    _backend.launch("row_gather_bwd", grad, idx, out, order, starts, B, M, rows, C,
                    DTYPES[grad.dtype], int(build))
    return out


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """table (B, S, C) at idx (B, M) int, or at a :class:`RowIndex` shared
    with other gathers -> (B, M, C), the rows of each cloud's table at its
    indices; under grad its backward is :func:`gather_rows_bwd`."""
    index = idx if isinstance(idx, RowIndex) else row_index(idx, table.shape[1])
    if torch.is_grad_enabled() and table.requires_grad:
        return RowGather.apply(table, index, gather_rows_bwd)
    return take_rows(table, index.idx)
