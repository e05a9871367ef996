"""Stage-II pretraining entry point: a few train steps of ACT_PointDistillation.

Counterpart of the model, optimizer and step part of
``act_tpu/engine/runner_pretrain.py:136-238``: build the model from the YAML,
draw the weights from a seed (or load a state dict), freeze the dVAE tokenizer
and store its matmul weights in bf16, build AdamW with CosLR, and take train
steps on the given batches or on the synthetic ShapeNet-55 clouds. Checkpoint
save and resume, the SVM probe, validation and the dataset loaders are not
ported yet.

  python -m act_tpu_torch.engine.runner_pretrain \\
      --config cfgs/pretrain/pretrain_act_distill.yaml --steps 3

The run is on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import torch
from torch import nn

from act_tpu_torch.engine import builder
from act_tpu_torch.engine.serve import Checkpoint, load_config, load_state_dict
from act_tpu_torch.engine.train_state import (pretrain_step, step_rngs, steps_per_epoch,
                                              timed_steps)
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import resolve_device

TOKENIZER = "dvae_tokenizer"
STAGE_I_KEYS = f"{TOKENIZER}.decoder."  # FoldingNet decoder, not built here


@dataclass
class PretrainRun:
    """What ``run_steps`` returns: the per-step losses, the host ms of each
    step (each ending in a device synchronize), and the final state."""
    losses: List[float]
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step_ms: List[float] = field(default_factory=list)


def build_pretrain_model(model_cfg, seed: int = 0,
                         state_dict: Optional[Checkpoint] = None) -> nn.Module:
    """``model_cfg`` built on the CPU with weights from ``seed``, or from a
    reference state dict / ``.pth`` (its Stage-I ``decoder.*`` keys are
    dropped, every other key must match)."""
    if model_cfg.NAME != "ACT_PointDistillation":
        raise NotImplementedError(f"{model_cfg.NAME} pretraining is not ported yet")
    with torch.device("meta"):
        model = MODELS.build(model_cfg)
    model = model.to_empty(device="cpu")
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        sd = {k: v for k, v in load_state_dict(state_dict).items()
              if not k.startswith(STAGE_I_KEYS)}
        model.load_state_dict(sd, strict=True)
    return model


def run_steps(config, steps: int, *, batches: Optional[Iterable] = None, seed: int = 0,
              device="cuda", state_dict: Optional[Checkpoint] = None) -> PretrainRun:
    """Take ``steps`` Stage-II train steps of ``config`` (a YAML path or a
    mapping) and return the losses and the final state.

    ``batches``: (B, N, 3) clouds, one a step; by default the synthetic
    ShapeNet-55 clouds at ``total_bs`` x ``npoints``. The lr schedule counts
    ``512 // total_bs`` steps an epoch, as the JAX runner does on those
    clouds. Every step ends in a device synchronize, so its host time is
    the step's time."""
    cfg = load_config(config)
    dev = resolve_device(device)
    model = build_pretrain_model(cfg.model, seed, state_dict)
    builder.freeze(model, [TOKENIZER])
    if bool(cfg.model.get("frozen_bf16", True)):
        builder.cast_frozen_bf16(model, [TOKENIZER])
    model = model.to(dev)
    optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
    clip = cfg.get("grad_norm_clip", None)
    losses, step_ms = timed_steps(
        lambda step, pts: pretrain_step(model, optimizer, schedule, pts, step,
                                        step_rngs(seed, step, dev), grad_norm_clip=clip),
        steps, cfg, batches, dev)
    return PretrainRun([float(x) for x in losses], model, optimizer, step_ms)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="cfgs/pretrain/pretrain_act_distill.yaml")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None, help="reference .pth to start from")
    args = ap.parse_args(argv)
    run = run_steps(args.config, args.steps, seed=args.seed, device=args.device,
                    state_dict=args.ckpt)
    for i, (loss, ms) in enumerate(zip(run.losses, run.step_ms)):
        print(f"step {i}: loss {loss:.6f}, {ms:.1f} ms")


if __name__ == "__main__":
    main()
