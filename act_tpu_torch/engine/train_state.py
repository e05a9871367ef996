"""The Stage-II pretrain train step.

Counterpart of ``act_tpu/engine/train_state.py:54-59, 107-170``
(``step_rngs``, ``make_pretrain_step``): augment, loss in training mode (the
frozen tokenizer's BatchNorm running statistics update as well), backward,
then AdamW at the scheduled lr. Every random draw of a step comes from one
generator per named stream, seeded from (seed, step, stream), on the step's
device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from act_tpu_torch.datasets.transforms import scale_and_translate

STREAMS = ("gumbel", "mask", "dropout", "droppath", "augment")


def step_rngs(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    """One generator per named stream for step ``step`` of a run from
    ``seed``, on ``device``."""
    gens = {}
    for i, name in enumerate(STREAMS):
        words = np.random.SeedSequence([seed, step, i]).generate_state(2, np.uint32)
        gens[name] = torch.Generator(device=device)
        gens[name].manual_seed((int(words[0]) << 32) | int(words[1]))
    return gens


def pretrain_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  schedule: Callable[[int], float], pts: torch.Tensor, step: int,
                  rngs: Dict[str, torch.Generator],
                  transform: Optional[Callable] = scale_and_translate,
                  grad_norm_clip: Optional[float] = None) -> torch.Tensor:
    """One train step on the (B, N, 3) batch ``pts``; returns the loss
    (detached, still on the device).

    A trainable parameter that the loss does not reach (the student's unused
    ``cls_head``) gets a zero gradient, so AdamW still decays it, as optax
    does with the zero gradients JAX gives it."""
    if transform is not None:
        pts = transform(pts, rngs["augment"])
    model.train()
    optimizer.zero_grad(set_to_none=False)
    loss = model(pts, rngs=rngs)
    loss.backward()
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if grad_norm_clip:
        torch.nn.utils.clip_grad_norm_(
            [p for g in optimizer.param_groups for p in g["params"]], grad_norm_clip)
    optimizer.step()
    return loss.detach()
