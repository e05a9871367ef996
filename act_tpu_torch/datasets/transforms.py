"""Batch point-cloud augmentations, drawn from an explicit generator.

Counterpart of ``act_tpu/datasets/transforms.py:21-48``; same ranges as the
reference (datasets/data_transforms.py:6-34). Over several ranks each
cloud's draw is its row of the global batch's (``parallel.rand_local``).
"""
from __future__ import annotations

import math

import torch

from act_tpu_torch.parallel.mesh import rand_local


def scale_and_translate(pc: torch.Tensor, generator: torch.Generator,
                        scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
                        translate_range: float = 0.2) -> torch.Tensor:
    """Per-cloud anisotropic scale U(2/3, 3/2) and shift U(-0.2, 0.2) on each
    axis (PointcloudScaleAndTranslate, the pretrain default). pc (B, N, 3)."""
    B = pc.shape[0]
    u = rand_local((2, B, 1, 3), generator, dim=1, dtype=pc.dtype, device=pc.device)
    scale = scale_low + (scale_high - scale_low) * u[0]
    shift = -translate_range + 2.0 * translate_range * u[1]
    return pc * scale + shift


def rotate_y_by(pc: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each cloud of pc (B, N, 3) about the up (y) axis by its angle
    (B,): ``pc @ R`` with R row-major as in the reference."""
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1)
    return torch.matmul(pc, R.reshape(-1, 3, 3).to(pc.dtype))


def rotate_y(pc: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-cloud rotation about y by an angle U(0, 2 pi) (PointcloudRotate,
    the finetune default). pc (B, N, 3)."""
    u = rand_local((pc.shape[0],), generator, device=pc.device)
    return rotate_y_by(pc, u * (2 * math.pi))
