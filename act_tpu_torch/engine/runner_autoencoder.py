"""Stage-I entry point: train steps of the dVAE autoencoder and its
reconstruction metrics.

Counterpart of the model, optimizer, step and validation part of
``act_tpu/engine/runner_autoencoder.py``: build the dVAE from the YAML with
weights drawn from a seed (no teacher checkpoint is in the repository, so the
teacher is random, as in the JAX runner without ``teacher_ckpt``), freeze the
teacher backbone and store its blocks in bf16 (``freeze_visual_embed``),
build AdamW with CosLR, and take train steps on the given batches or on the
synthetic ShapeNet-55 clouds with the Gumbel temperature and the KLD weight
on their cosine anneals. Checkpoints and resume, ``test_net``, the
reconstruction dump, the per-taxonomy table and the dataset loaders are not
ported yet.

  python -m act_tpu_torch.engine.runner_autoencoder \\
      --config cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml --steps 3

The run is on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from act_tpu_torch.engine import builder
from act_tpu_torch.engine.serve import load_config
from act_tpu_torch.engine.train_state import (autoencoder_step, step_rngs, steps_per_epoch,
                                              timed_steps)
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import resolve_device
from act_tpu_torch.utils.metrics import Metrics
from act_tpu_torch.utils.misc import cosine_anneal

KLD_DELAY = 10000  # iterations before the KLD weight starts its ramp


def get_temp(config, n_itr: int) -> float:
    """Gumbel temperature at iteration ``n_itr`` (``runner_autoencoder.py:32-37``)."""
    t = config.get("temp")
    if t is None:
        return 1.0
    return cosine_anneal(n_itr, float(t.start), float(t.target), int(t.ntime))


def get_kld_weight(config, n_itr: int) -> float:
    """KLD weight at iteration ``n_itr``: 0 for the first 10 000 iterations,
    then a cosine ramp (``runner_autoencoder.py:40-49``)."""
    k = config.get("kldweight")
    if k is None or n_itr < KLD_DELAY:
        return 0.0
    return cosine_anneal(n_itr - KLD_DELAY, float(k.start), float(k.target), int(k.ntime))


@dataclass
class AutoencoderRun:
    """What ``run_autoencoder_steps`` returns: per-step losses and their recon
    and KLD terms, the temperature and KLD weight of each step, the host ms
    of each step (each ending in a device synchronize), and the final state."""
    losses: List[float]
    recon: List[float]
    kld: List[float]
    temps: List[float]
    kld_weights: List[float]
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step_ms: List[float] = field(default_factory=list)


def build_autoencoder_model(model_cfg, seed: int = 0) -> nn.Module:
    """``model_cfg`` (a dVAE) built on the CPU with weights drawn from ``seed``."""
    with torch.device("meta"):
        model = MODELS.build(model_cfg)
    if not hasattr(model, "recon_loss"):
        raise NotImplementedError(f"{model_cfg.NAME} is not a Stage-I dVAE")
    model = model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def prepare_model(cfg, seed: int, device) -> nn.Module:
    """The config's dVAE from ``seed``, frozen and cast as the JAX runner
    does it, on ``device``."""
    model = build_autoencoder_model(cfg.model, seed)
    if getattr(model, "has_teacher", False) and bool(cfg.model.get("freeze_visual_embed", False)):
        builder.freeze_teacher_backbone(model, bool(cfg.model.get("frozen_bf16", True)))
    return model.to(device)


def run_autoencoder_steps(config, steps: int, *, batches: Optional[Iterable] = None,
                          seed: int = 0, start_itr: int = 0, device="cuda"
                          ) -> AutoencoderRun:
    """Take ``steps`` Stage-I train steps of ``config`` (a YAML path or a
    mapping) and return the losses and the final state.

    ``batches``: (B, N, 3) clouds, one a step; by default the synthetic
    ShapeNet-55 clouds at ``total_bs`` x ``npoints``. ``start_itr`` is the
    anneals' iteration counter at the first step, as after a resume; the
    optimizer and the lr schedule start fresh, counting ``512 // total_bs``
    steps an epoch as the JAX runner does on those clouds. Every step ends in
    a device synchronize, so its host time is the step's time."""
    cfg = load_config(config)
    dev = resolve_device(device)
    model = prepare_model(cfg, seed, dev)
    optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
    clip = cfg.get("grad_norm_clip", None)
    temps = [get_temp(cfg, start_itr + i) for i in range(steps)]
    kld_weights = [get_kld_weight(cfg, start_itr + i) for i in range(steps)]
    out, step_ms = timed_steps(
        lambda step, pts: autoencoder_step(model, optimizer, schedule, pts, step,
                                           step_rngs(seed, step, dev), temps[step],
                                           kld_weights[step], clip),
        steps, cfg, batches, dev)
    losses, recon, kld = ([float(o[i]) for o in out] for i in range(3))
    return AutoencoderRun(losses, recon, kld, temps[:len(out)], kld_weights[:len(out)],
                          model, optimizer, step_ms)


def validate(model: nn.Module, clouds: Iterable, consider_metric: str = "CDL1"
             ) -> Tuple[Metrics, List[List[float]]]:
    """Reconstruction metrics of ``model`` over ``clouds`` (each (N, 3) or
    (1, N, 3)), one cloud a forward as the reference's batch size 1: the eval
    recon forward with ``hard=True`` at temperature 1 and a 'gumbel'
    generator seeded 0 for every cloud (the JAX runner's fixed
    ``PRNGKey(0)``, ``runner_autoencoder.py:293-304``), then ``Metrics.get``
    of the whole fine reconstruction against the cloud
    (``runner_autoencoder.py:307-337``). Returns (the mean metrics, each
    cloud's [F-Score, CDL1, CDL2])."""
    model.eval()
    dev = next(model.parameters()).device
    per_cloud = []
    with torch.no_grad():
        for pts in clouds:
            pts = torch.as_tensor(pts, dtype=torch.float32).to(dev).reshape(1, -1, 3)
            rngs = {"gumbel": torch.Generator(device=dev).manual_seed(0)}
            fine = model(pts, 1.0, True, rngs=rngs)[1]
            per_cloud.append(Metrics.get(fine[0], pts[0]))
    means = [sum(v) / len(per_cloud) for v in zip(*per_cloud)]
    return Metrics(consider_metric, means), per_cloud


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--start_itr", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = run_autoencoder_steps(args.config, args.steps, seed=args.seed,
                                start_itr=args.start_itr, device=args.device)
    for i, ms in enumerate(run.step_ms):
        print(f"step {i}: loss {run.losses[i]:.6f} (recon {run.recon[i]:.6f}, kld "
              f"{run.kld[i]:.6f}), temp {run.temps[i]:.4f}, kld weight "
              f"{run.kld_weights[i]:.5f}, {ms:.1f} ms")


if __name__ == "__main__":
    main()
