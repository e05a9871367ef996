"""The Stage-II pretrain, the Stage-I autoencoder, the finetune and the
segmentation train steps.

Counterpart of ``act_tpu/engine/train_state.py:54-59, 107-170, 209-283``
(``step_rngs``, ``make_pretrain_step``, ``make_autoencoder_step``,
``make_finetune_step``) and of the train steps of
``act_tpu/engine/runner_segmentation.py:209-225, 340-356``: loss in
training mode (BatchNorm running statistics update as well, frozen ones
included), backward, then the config's optimizer at the scheduled lr (with
``step_per_update`` k, only every k-th micro-step updates, on the mean of
the k gradients) and, for ACT_PointBERT, the EMA of the k encoder after
every micro-step. Every random draw of a
step comes from one generator per named stream, seeded from (seed, step,
stream), on the step's device. ``timed_steps`` is the trainers' step loop.
Over several ranks a step is the one-process step on the global batch: the
gradients are averaged before the clip, BatchNorm takes global statistics
and each draw is the rank's rows of the global draw (``act_tpu_torch.parallel``).
Under tensor parallelism each rank holds a shard of the split weights
(``parallel/tp.py``), the gradients are averaged over the data group only
and the clip reads the norm of the whole gradient.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch.datasets.synthetic import SYNTHETIC_LEN, synthetic_batch
from act_tpu_torch.datasets.transforms import scale_and_translate
from act_tpu_torch.engine.builder import MultiSteps
from act_tpu_torch.models.point_transformer import get_loss_acc
from act_tpu_torch.models.segmentation import nll_seg_loss
from act_tpu_torch.parallel import all_reduce_mean, tp

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
                  grad_norm_clip: Optional[float] = None,
                  ema_momentum: Optional[float] = None) -> torch.Tensor:
    """One Stage-II train step on the (B, N, 3) batch ``pts``; returns the
    loss (detached, still on the device). A model that returns a tuple of
    losses (ACT_PointBERT) trains on their sum. With ``ema_momentum`` m,
    every parameter of ``model.transformer_k`` becomes ``k * m + q * (1 -
    m)`` of ``model.transformer_q`` after the optimizer step (every micro-step)
    (``train_state.py:157-163``); BatchNorm running statistics are not
    averaged."""
    if transform is not None:
        pts = transform(pts, rngs["augment"])
    model.train()
    optimizer.zero_grad(set_to_none=False)
    out = model(pts, rngs=rngs)
    loss = sum(out) if isinstance(out, tuple) else out
    loss.backward()
    _update(optimizer, schedule, step, grad_norm_clip)
    if ema_momentum is not None:
        ema_update(model.transformer_k, model.transformer_q, ema_momentum)
    return loss.detach()


@torch.no_grad()
def ema_update(k: nn.Module, q: nn.Module, m: float) -> None:
    """Each parameter of ``k`` to ``k * m + q * (1 - m)``, two products
    rounded to f32 and their sum, as the JAX step computes it."""
    ks, qs = dict(k.named_parameters()), dict(q.named_parameters())
    if ks.keys() != qs.keys():
        raise ValueError("the EMA needs k and q of the same parameters")
    names = sorted(ks)
    kt = [ks[n] for n in names]
    torch._foreach_mul_(kt, m)
    torch._foreach_add_(kt, torch._foreach_mul([qs[n] for n in names], 1.0 - m))


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
    _update(optimizer, schedule, step, grad_norm_clip)
    return loss.detach(), recon.detach(), kld.detach()


def finetune_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  schedule: Callable[[int], float], pts: torch.Tensor, labels: torch.Tensor,
                  step: int, rngs: Dict[str, torch.Generator],
                  transform: Optional[Callable] = None,
                  grad_norm_clip: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One classification train step on the (B, N, 3) batch ``pts`` and its
    (B,) labels: ``transform(pts, rngs['augment'])`` when given, the
    train-mode forward, CE loss, backward, clip, the optimizer at the scheduled lr.
    Returns (loss, accuracy in %), detached, still on the device."""
    if transform is not None:
        pts = transform(pts, rngs["augment"])
    model.train()
    optimizer.zero_grad(set_to_none=False)
    loss, acc = get_loss_acc(model(pts, rngs=rngs), labels)
    loss.backward()
    _update(optimizer, schedule, step, grad_norm_clip)
    return loss.detach(), acc.detach()


def seg_step(model: nn.Module, optimizer: torch.optim.Optimizer,
             schedule: Callable[[int], float], pts: torch.Tensor, target: torch.Tensor,
             step: int, rngs: Dict[str, torch.Generator],
             cls_label_one_hot: Optional[torch.Tensor] = None,
             weight: Optional[torch.Tensor] = None, grad_norm_clip: float = 10.0
             ) -> torch.Tensor:
    """One segmentation train step on the (B, N, 3) batch ``pts`` and its
    (B, N) labels: the train-mode forward (with the (B, 16) one-hot for part
    segmentation), the NLL (class-weighted with ``weight``), backward, the
    clip, AdamW at the scheduled lr. Returns the loss, detached, still on the
    device."""
    model.train()
    optimizer.zero_grad(set_to_none=False)
    inputs = (pts,) if cls_label_one_hot is None else (pts, cls_label_one_hot)
    loss = nll_seg_loss(model(*inputs, rngs=rngs), target, weight)
    loss.backward()
    _update(optimizer, schedule, step, grad_norm_clip)
    return loss.detach()


def _update(optimizer, schedule: Callable[[int], float], step: int,
            grad_norm_clip: Optional[float]) -> None:
    """Average the gradients over the ranks, clip (when set) and take the
    optimizer's step at ``schedule(step)``.

    A trainable parameter that the loss does not reach (the student's unused
    ``cls_head``) gets a zero gradient, so AdamW still decays it, as optax
    does with the zero gradients JAX gives it. Under a process group the
    gradients are all-reduced (SUM, then / R, one flattened bucket a dtype;
    no ``DistributedDataParallel`` wrapper, so state-dict keys keep their
    layout) before the clip, which then clips the global gradient as JAX
    does. With gradient accumulation (``builder.MultiSteps``) the averaged
    gradients of every micro-step go into the running mean (one all-reduce
    a micro-step, as JAX's step takes the gradient of the global batch; one
    a k-step update would differ only in rounding), and only the k-th
    micro-step clips the mean and steps, at ``schedule(optimizer.updates)``.
    Under tensor parallelism the all-reduce goes over the data group: a
    sharded gradient is this rank's own shard, and a replicated one is equal
    on the model peers; the clip (``tp.clip_grad_norm_``) sums the sharded
    gradients' squared norms over the model group and counts the replicated
    ones once; the optimizer's moments and ``MultiSteps``'s running mean are
    shards like their parameters."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    all_reduce_mean(grads)
    if isinstance(optimizer, MultiSteps):
        if not optimizer.accumulate(grads):
            return
        step = optimizer.updates
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    if grad_norm_clip:
        tp.clip_grad_norm_(params, grad_norm_clip)
    optimizer.step()
