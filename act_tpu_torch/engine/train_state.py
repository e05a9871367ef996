"""The Stage-II pretrain and the Stage-I autoencoder train steps.

Counterpart of ``act_tpu/engine/train_state.py:54-59, 107-170, 209-245``
(``step_rngs``, ``make_pretrain_step``, ``make_autoencoder_step``): loss in
training mode (BatchNorm running statistics update as well, frozen ones
included), backward, then AdamW at the scheduled lr. Every random draw of a
step comes from one generator per named stream, seeded from (seed, step,
stream), on the step's device. ``timed_steps`` is the trainers' step loop.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch.datasets.synthetic import SYNTHETIC_LEN, synthetic_batch
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


def steps_per_epoch(cfg) -> int:
    """Steps an epoch of the synthetic ShapeNet-55 clouds at ``total_bs``,
    as the JAX runners count them for the lr schedule."""
    return max(SYNTHETIC_LEN // int(cfg.total_bs), 1)


def timed_steps(step_fn: Callable[[int, torch.Tensor], Any], steps: int, cfg,
                batches: Optional[Iterable], device: torch.device
                ) -> Tuple[List[Any], List[float]]:
    """Call ``step_fn(step, pts)`` for ``steps`` steps and return its
    outputs and the host ms of each call, each ending in a device
    synchronize. ``batches``: (B, N, 3) clouds, one a step; by default the
    synthetic ShapeNet-55 clouds at ``cfg``'s ``total_bs`` x ``npoints``."""
    if batches is None:
        bs, npoints = int(cfg.total_bs), int(cfg.dataset.train.others.npoints)
        distinct = [torch.from_numpy(synthetic_batch(i, bs, npoints)).to(device)
                    for i in range(min(steps, steps_per_epoch(cfg)))]
        batches = (distinct[i % len(distinct)] for i in range(steps))
    outs, step_ms = [], []
    for step, pts in zip(range(steps), batches):
        pts = torch.as_tensor(pts, dtype=torch.float32).to(device)
        t0 = time.perf_counter()
        outs.append(step_fn(step, pts))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return outs, step_ms


def pretrain_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  schedule: Callable[[int], float], pts: torch.Tensor, step: int,
                  rngs: Dict[str, torch.Generator],
                  transform: Optional[Callable] = scale_and_translate,
                  grad_norm_clip: Optional[float] = None) -> torch.Tensor:
    """One Stage-II train step on the (B, N, 3) batch ``pts``; returns the
    loss (detached, still on the device)."""
    if transform is not None:
        pts = transform(pts, rngs["augment"])
    model.train()
    optimizer.zero_grad(set_to_none=False)
    loss = model(pts, rngs=rngs)
    loss.backward()
    _update(optimizer, schedule(step), grad_norm_clip)
    return loss.detach()


def autoencoder_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                     schedule: Callable[[int], float], pts: torch.Tensor, step: int,
                     rngs: Dict[str, torch.Generator], temperature: float,
                     kld_weight: float, grad_norm_clip: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Stage-I dVAE train step on the (B, N, 3) batch ``pts`` at the
    annealed Gumbel ``temperature`` and ``kld_weight``: loss = recon +
    kld_weight * kld (no augmentation, as the JAX runner builds the step).
    Returns (loss, recon, kld), detached, still on the device."""
    model.train()
    optimizer.zero_grad(set_to_none=False)
    ret = model(pts, temperature, False, rngs=rngs)
    recon, kld = model.get_loss(ret, pts)
    loss = recon + kld_weight * kld.float()  # an f32 weight times a bf16 KLD is f32 in JAX
    loss.backward()
    _update(optimizer, schedule(step), grad_norm_clip)
    return loss.detach(), recon.detach(), kld.detach()


def _update(optimizer: torch.optim.Optimizer, lr: float,
            grad_norm_clip: Optional[float]) -> None:
    """Clip (when set) and take the AdamW step at ``lr``.

    A trainable parameter that the loss does not reach (the student's unused
    ``cls_head``) gets a zero gradient, so AdamW still decays it, as optax
    does with the zero gradients JAX gives it."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if grad_norm_clip:
        torch.nn.utils.clip_grad_norm_(
            [p for g in optimizer.param_groups for p in g["params"]], grad_norm_clip)
    optimizer.step()
