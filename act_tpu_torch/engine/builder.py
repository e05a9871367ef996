"""Optimizer, LR- and BN-momentum-schedule and dataset builders, freezing and
the frozen-bf16 cast.

Counterpart of ``act_tpu/engine/builder.py:32-88, 113-220`` and of the Stage-I
freezing of ``act_tpu/engine/runner_autoencoder.py:130-143`` for each teacher arch:

- weight decay on every trainable parameter except 1-D ones and those whose
  name holds 'bias' or 'token' (reference add_weight_decay, tools/builder.py:38-51);
- freezing is ``requires_grad=False`` and leaving the parameter out of the
  optimizer (the JAX package masks its updates to zero);
- CosLR is optax's ``warmup_cosine_decay_schedule``: linear from 1e-6 to
  the base lr over ``initial_epochs``, then a cosine to 1e-7, per step;
- AdamW is ``torch.optim.AdamW`` (optax ``adamw``: b1 0.9, b2 0.999, eps
  1e-8, decoupled decay), with ``clip_grad_norm_`` first when
  ``grad_norm_clip`` is set;
- the BN-momentum schedule sets each ``BatchNorm.momentum`` (torch's
  convention) for the epoch, what the JAX package's ``apply_bn_ratio``
  retargets its fixed-momentum update to;
- ``dataset_builder`` makes the (dataset, loader) of a config node, shuffled
  and without the last partial batch for ``subset: train``; workers for real data.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from act_tpu_torch.datasets.build import build_dataset_from_cfg
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.models.common import BatchNorm
from act_tpu_torch.models.point_transformer import trainable
from act_tpu_torch.models.teacher import TEACHER_LAYOUT
from act_tpu_torch.utils.misc import bn_momentum_schedule

FROZEN_KEEP_F32 = ("norm", "ln_", "bn", "gn")


def decays(name: str, p: torch.Tensor) -> bool:
    """True where AdamW's weight decay applies (``builder.py:32-42``)."""
    n = name.lower()
    return not (p.ndim <= 1 or "bias" in n or "token" in n)


def freeze(model: nn.Module, prefixes: Iterable[str]) -> None:
    """``requires_grad=False`` on every parameter under the given prefixes."""
    prefixes = tuple(f"{p}." for p in prefixes)
    for name, p in model.named_parameters():
        if name.startswith(prefixes):
            p.requires_grad_(False)


def freeze_transfer(model: nn.Module, transfer_type: str) -> None:
    """``requires_grad=False`` on every parameter of a PointTransformer that
    ``transfer_type`` does not train (``point_transformer.trainable``)."""
    for name, p in model.named_parameters():
        if not trainable(name, transfer_type):
            p.requires_grad_(False)


def cast_frozen_bf16(model: nn.Module, prefixes: Iterable[str]) -> None:
    """Store the matmul weights under the given (frozen) prefixes in bf16, as
    ``cast_frozen_bf16`` does (``builder.py:54-68``): every parameter of two or
    more dimensions whose name holds none of 'norm', 'ln_', 'bn', 'gn'. Norm
    parameters and 1-D tensors stay f32."""
    prefixes = tuple(f"{p}." for p in prefixes)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.startswith(prefixes) and p.ndim >= 2
                    and not any(s in name.lower() for s in FROZEN_KEEP_F32)):
                p.data = p.data.to(torch.bfloat16)


def freeze_teacher_backbone(model: nn.Module, cast_bf16: bool = True) -> None:
    """Stage I's ``freeze_visual_embed``: the JAX mask (``blocks_`` and
    ``norm``, ``runner_autoencoder.py:131-135``) for the model's teacher arch
    (``TEACHER_LAYOUT``): the ViT's blocks and final norm, CLIP's resblocks
    (its ``ln_pre``/``ln_post`` train, as in the JAX package), BERT's layers.
    Only the blocks are stored in bf16. The prompts, ``proj_pre``,
    ``proj_post`` and ``visual_pos_embed`` stay trainable, and gradients flow
    through the frozen blocks to them and to everything before the teacher."""
    blocks, frozen = TEACHER_LAYOUT[model.teacher_arch]
    freeze(model, frozen)
    if cast_bf16:
        cast_frozen_bf16(model, [blocks])


def cos_lr(base_lr: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(1e-6, base_lr, warmup_steps,
    decay_steps, 1e-7)`` as a function of the step."""
    init_value, end_value = 1e-6, 1e-7
    alpha = end_value / base_lr if base_lr else 0.0
    cos_steps = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - step / warmup_steps
            return (init_value - base_lr) * frac + base_lr
        count = min(step - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cos_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)
    return schedule


def build_schedule(config, steps_per_epoch: int) -> Callable[[int], float]:
    """The config's scheduler (CosLR only) as a function of the step,
    with ``build_schedule``'s step counts (``builder.py:75-88``)."""
    sche = config.scheduler
    if sche.type != "CosLR":
        raise NotImplementedError(f"scheduler {sche.type} is not ported yet (CosLR only)")
    warmup = max(int(sche.kwargs.get("initial_epochs", 0)) * steps_per_epoch, 1)
    total = max(int(sche.kwargs.epochs) * steps_per_epoch, warmup + 1)
    return cos_lr(float(config.optimizer.kwargs.lr), warmup, total)


def build_optimizer(config, model: nn.Module, steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """AdamW over the trainable parameters, in a decayed and an undecayed
    group, and the lr schedule; the caller sets each group's lr to
    ``schedule(step)`` before a step."""
    opt = config.optimizer
    if opt.type != "AdamW":
        raise NotImplementedError(f"optimizer {opt.type} is not ported yet (AdamW only)")
    if int(config.get("step_per_update", 1)) != 1:
        raise NotImplementedError("step_per_update > 1 is not ported yet")
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    wd = float(opt.kwargs.get("weight_decay", 0.0))
    groups = [{"params": [p for n, p in params if decays(n, p)], "weight_decay": wd},
              {"params": [p for n, p in params if not decays(n, p)], "weight_decay": 0.0}]
    schedule = build_schedule(config, steps_per_epoch)
    return (torch.optim.AdamW(groups, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8),
            schedule)


def build_bnm_schedule(config) -> Optional[Callable[[int], float]]:
    """epoch -> BatchNorm momentum (torch's convention) from the config's
    ``bnmscheduler`` node (reference tools/builder.py:89-93), or None when the
    config has none (no shipped config has one)."""
    node = config.get("bnmscheduler", None)
    if node is None:
        return None
    if node["type"] != "Lambda":
        raise NotImplementedError(node["type"])
    k = node["kwargs"]
    if k.get("decay_step", None) is None:
        raise NotImplementedError("bnmscheduler requires decay_step")
    return partial(bn_momentum_schedule, bn_momentum=float(k["bn_momentum"]),
                   bn_decay=float(k["bn_decay"]), decay_step=int(k["decay_step"]),
                   lowest_decay=float(k["lowest_decay"]))


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Every BatchNorm of ``model`` updates its running statistics as
    ``(1 - momentum) * running + momentum * batch`` from now on."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = float(momentum)


def dataset_builder(dataset_cfg, seed: int = 0, num_workers: int = 0):
    """A dataset config node -> (dataset, DataLoader) (``builder.py:191-220``):
    batch size ``others.bs``, shuffled by (seed, epoch) and without the last
    partial batch for ``subset: train``. ``num_workers`` forked workers build
    the batches of real data; synthetic data, and real data without workers,
    is built in this process between steps, with no prefetch thread. The
    datasets' items are many small numpy calls (the ShapeNet ``.npy`` reads,
    the in-memory ModelNet pickles' normalise and shuffle), and a thread
    running them holds the interpreter lock that the step's eager kernel
    launches wait on (``python -m act_tpu_torch.loader_sweep``; PERF.md §6)."""
    dataset = build_dataset_from_cfg(dataset_cfg)
    node = dataset_cfg.others if "others" in dataset_cfg else dataset_cfg
    shuffle = node.subset == "train"
    workers = 0 if getattr(dataset, "synthetic", False) else int(num_workers)
    loader = DataLoader(dataset, batch_size=int(node.bs), shuffle=shuffle,
                        drop_last=shuffle, seed=seed, prefetch=2 if workers else 0,
                        num_workers=workers)
    return dataset, loader
