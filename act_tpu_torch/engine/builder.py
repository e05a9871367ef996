"""Optimizer, LR- and BN-momentum-schedule and dataset builders, freezing and
the frozen-bf16 cast.

Counterpart of ``act_tpu/engine/builder.py:32-88, 113-220`` and of the Stage-I
freezing of ``act_tpu/engine/runner_autoencoder.py:130-143`` for each teacher arch:

- weight decay on every trainable parameter except 1-D ones and those whose
  name holds 'bias' or 'token' (reference add_weight_decay, tools/builder.py:38-51);
- freezing is ``requires_grad=False`` and leaving the parameter out of the
  optimizer (the JAX package masks its updates to zero): no update, no moments;
- the schedules of ``builder.py:75-109``, per step: CosLR is optax's
  ``warmup_cosine_decay_schedule`` (linear from 1e-6 to the base lr over
  ``initial_epochs``, then a cosine to 1e-7); LambdaLR is ``base_lr *
  max(lr_decay ** (epoch / decay_step), lowest_decay)``, StepLR ``base_lr *
  gamma ** (epoch // step_size)``, ``function`` the constant base lr, with
  epoch = count // steps_per_epoch;
- the optimizers of ``builder.py:144-161`` (optax b1 0.9, b2 0.999, eps
  1e-8): AdamW, and RAdam, as ``torch.optim.AdamW`` (decoupled decay on the
  decayed group; the JAX package builds RAdam as AdamW too); Adam as
  ``torch.optim.Adam`` without weight decay, whatever the kwargs say; SGD
  as ``torch.optim.SGD`` with Nesterov momentum 0.9 and ``weight_decay``
  added to every trainable parameter's gradient (optax
  ``add_decayed_weights`` has no mask); ``clip_grad_norm_`` first when
  ``grad_norm_clip`` is set (``train_state._update``); any other type raises;
- ``step_per_update`` k > 1 is optax ``MultiSteps`` (:class:`MultiSteps`);
- the BN-momentum schedule sets each ``BatchNorm.momentum`` (torch's
  convention) for the epoch, what the JAX package's ``apply_bn_ratio``
  retargets its fixed-momentum update to;
- ``dataset_builder`` makes the (dataset, loader) of a config node, shuffled
  and without the last partial batch for ``subset: train``; workers for real data;
  each rank its share of the global batch.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from act_tpu_torch.datasets.build import build_dataset_from_cfg
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.models.common import BatchNorm
from act_tpu_torch.models.point_transformer import trainable
from act_tpu_torch.models.teacher import TEACHER_LAYOUT
from act_tpu_torch.parallel import data_count, data_index
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
    """The config's scheduler as a function of the optimizer's update count,
    with ``build_schedule``'s step counts (``builder.py:75-109``)."""
    sche, base_lr = config.scheduler, float(config.optimizer.kwargs.lr)
    k = sche.get("kwargs", {})
    if sche.type == "CosLR":
        warmup = max(int(k.get("initial_epochs", 0)) * steps_per_epoch, 1)
        total = max(int(k.epochs) * steps_per_epoch, warmup + 1)
        return cos_lr(base_lr, warmup, total)
    if sche.type == "LambdaLR":
        decay, decay_step, lowest = float(k.lr_decay), int(k.decay_step), float(k.lowest_decay)
        return lambda step: base_lr * max(
            decay ** ((step // steps_per_epoch) / decay_step), lowest)
    if sche.type == "StepLR":
        gamma, step_size = float(k.get("gamma", 0.1)), int(k.step_size)
        return lambda step: base_lr * gamma ** ((step // steps_per_epoch) // step_size)
    if sche.type == "function":
        return lambda step: base_lr
    raise NotImplementedError(sche.type)


class MultiSteps:
    """optax ``MultiSteps`` (``builder.py:181-183``) around a torch optimizer:
    gradient accumulation over ``every_k`` micro-steps.

    ``accumulate`` folds a micro-step's gradients into the running mean
    ``acc += (g - acc) / (n + 1)`` (optax's ``use_grad_mean``); on the k-th
    it puts the mean into the gradients, resets, and the caller clips and
    steps the inner optimizer once. In between the weights stay as they
    are, and the inner optimizer's moments and update count do not move, so
    the schedule is indexed by ``updates``, the updates taken, while
    ``steps_per_epoch`` counts batches. The state dict carries the inner
    optimizer's, the accumulated gradients and both counts, so a save
    between updates resumes bit for bit."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        self.inner, self.every_k = inner, int(every_k)
        self.mini_step, self.updates = 0, 0
        self.acc = [torch.zeros_like(p) for g in inner.param_groups for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def accumulate(self, grads: List[torch.Tensor]) -> bool:
        """Fold ``grads`` into the mean; True on the k-th micro-step, with
        the mean of the k written into ``grads`` and the mean reset."""
        n = self.mini_step
        torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(grads, self.acc),
                                                         float(n + 1)))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return False
        torch._foreach_copy_(grads, self.acc)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def step(self) -> None:
        self.inner.step()
        self.updates += 1

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step, "updates": self.updates,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state: Dict) -> None:
        if int(state["every_k"]) != self.every_k:
            raise ValueError(f"the state accumulates over {state['every_k']} micro-steps, "
                             f"this run over {self.every_k}")
        self.inner.load_state_dict(state["inner"])
        self.mini_step, self.updates = int(state["mini_step"]), int(state["updates"])
        with torch.no_grad():
            for a, saved in zip(self.acc, state["acc"], strict=True):
                a.copy_(saved)


def build_optimizer(config, model: nn.Module, steps_per_epoch: int):
    """The config's optimizer over the trainable parameters (the decayed and
    the undecayed group for AdamW and RAdam), wrapped in :class:`MultiSteps`
    when ``step_per_update`` > 1, and the lr schedule (update count -> lr);
    the caller sets each group's lr before a step (``train_state._update``)."""
    opt = config.optimizer
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    wd = float(opt.kwargs.get("weight_decay", 0.0))
    schedule = build_schedule(config, steps_per_epoch)
    lr = schedule(0)
    if opt.type in ("AdamW", "RAdam"):
        groups = [{"params": [p for n, p in params if decays(n, p)], "weight_decay": wd},
                  {"params": [p for n, p in params if not decays(n, p)], "weight_decay": 0.0}]
        optimizer = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif opt.type == "Adam":
        optimizer = torch.optim.Adam([p for _, p in params], lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)
    elif opt.type == "SGD":
        optimizer = torch.optim.SGD([p for _, p in params], lr=lr, momentum=0.9,
                                    nesterov=True, weight_decay=wd)
    else:
        raise NotImplementedError(opt.type)
    every_k = int(config.get("step_per_update", 1))
    if every_k > 1:
        optimizer = MultiSteps(optimizer, every_k)
    return optimizer, schedule


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
    launches wait on (``python -m act_tpu_torch.loader_sweep``; PERF.md §6).
    A ModelNet tree without its FPS cache builds it on the node's
    ``FPS_DEVICE`` (the trainers set it to theirs; default the card).

    The configs' batch sizes are global: over R data indices each rank
    loads ``bs // R`` clouds a batch (at least 1) from its data index's
    share of the index space (``DataLoader(num_replicas=R, rank=r)``; model
    peers load the same clouds)."""
    dataset = build_dataset_from_cfg(dataset_cfg)
    node = dataset_cfg.others if "others" in dataset_cfg else dataset_cfg
    shuffle = node.subset == "train"
    workers = 0 if getattr(dataset, "synthetic", False) else int(num_workers)
    R = data_count()
    loader = DataLoader(dataset, batch_size=max(int(node.bs) // R, 1), shuffle=shuffle,
                        drop_last=shuffle, seed=seed, prefetch=2 if workers else 0,
                        num_workers=workers, num_replicas=R, rank=data_index())
    return dataset, loader
