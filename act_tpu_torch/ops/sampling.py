"""Hard Gumbel sampling: the CUDA kernel ``csrc/gumbel.cu`` and its wrapper.

Counterpart of ``act_tpu/ops/sampling.py``. The noise is the counter hash of
the JAX kernel's interpret path, so the ids equal ``gumbel_argmax_pallas``
in interpret mode for the same seed words; see the note at the top of the
source.
"""
from __future__ import annotations

import torch

from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.reference import gumbel_argmax_ref, gumbel_chunk

DTYPES = (torch.bfloat16, torch.float32)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """Two int32 seed words from ``generator``, on its device (no host sync)."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def gumbel_argmax(logits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """ids = argmax(logits + Gumbel noise) over the last axis.

    logits (..., V) bf16 or f32, seed (2,) int32 on the same device -> (...)
    int32, the first index of the maximum. Forward-value equal to a hard
    ``gumbel_softmax`` at tau 1; no gradient flows."""
    if logits.dim() < 1 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be (..., V) with V >= 1, got {tuple(logits.shape)}")
    if seed.shape != (2,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be a (2,) int32 tensor, got {seed.dtype} {tuple(seed.shape)}")
    if seed.device != logits.device:
        raise ValueError(f"seed on {seed.device}, logits on {logits.device}")
    if logits.device.type == "cpu":
        return gumbel_argmax_ref(logits, seed)
    if logits.dtype not in DTYPES:
        raise ValueError(f"gumbel_argmax logits: the CUDA kernel takes bf16 or float32, "
                         f"got {logits.dtype}")
    _backend.check_cuda_input(logits, "gumbel_argmax logits", logits.dtype)
    _backend.check_cuda_input(seed, "gumbel_argmax seed", torch.int32)
    *lead, v = logits.shape
    rows = logits.numel() // v
    out = torch.empty(*lead, dtype=torch.int32, device=logits.device)
    if rows:
        _backend.launch("gumbel_argmax", logits, seed, out, rows, v, gumbel_chunk(rows, v),
                        int(logits.dtype == torch.bfloat16))
    return out
