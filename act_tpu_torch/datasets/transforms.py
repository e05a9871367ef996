"""Batch point-cloud augmentations, drawn from an explicit generator.

Counterpart of ``act_tpu/datasets/transforms.py:21-32``; same ranges as the
reference (datasets/data_transforms.py:20-34).
"""
from __future__ import annotations

import torch


def scale_and_translate(pc: torch.Tensor, generator: torch.Generator,
                        scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
                        translate_range: float = 0.2) -> torch.Tensor:
    """Per-cloud anisotropic scale U(2/3, 3/2) and shift U(-0.2, 0.2) on each
    axis (PointcloudScaleAndTranslate, the pretrain default). pc (B, N, 3)."""
    B = pc.shape[0]
    u = torch.rand(2, B, 1, 3, generator=generator, device=pc.device, dtype=pc.dtype)
    scale = scale_low + (scale_high - scale_low) * u[0]
    shift = -translate_range + 2.0 * translate_range * u[1]
    return pc * scale + shift
