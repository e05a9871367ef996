"""Stage-I entry points: train the dVAE autoencoder, validate it, test it.

Counterpart of ``act_tpu/engine/runner_autoencoder.py`` (reference
tools/runner_autoencoder.py): build the dVAE from the YAML with weights drawn
from a seed, load the 2D teacher from ``model.teacher_ckpt`` when the file is
there (a timm ViT, CLIP or HuggingFace BERT ``.pth`` by the teacher's arch;
else the teacher stays random, with a warning, as in the JAX runner), freeze
the teacher backbone and store its blocks in bf16 (``freeze_visual_embed``),
build AdamW with CosLR, and train on the ShapeNet-55 loader with the Gumbel
temperature and the KLD weight on their cosine anneals over the iteration
count. Each epoch ends in a validation
(the per-taxonomy table of F-Score, CDL1 and CDL2, its Overall row the mean
of the category means), ckpt-best on ``consider_metric`` (CDL1, lower is
better) and ckpt-last; ``resume`` continues from ckpt-last. ``validate_net``
and ``test_net`` evaluate a checkpoint; ``test_net`` also writes the ground
truth and the reconstruction of the first clouds as text files (the JAX
runner's rendered ``.jpg`` files need matplotlib and are not written).
``run_autoencoder_steps`` takes train steps on given batches or on the
synthetic clouds, without loader or checkpoints. Over several ranks
(``act_tpu_torch.parallel``) each rank trains on its share of the global
batch, only rank 0 writes checkpoints, and ``validate`` gathers every
rank's per-cloud metrics and taxonomies (without the loader's padded
repeats, back in the dataset's order) before the table, so the table is the
one-rank table over the same clouds; the JAX runner builds each process's
table from its own shard (ROADMAP.md §3, fault (d)). ``run_net`` polls the
preemption guard (``engine/preemption.py``) after every step.

  python -m act_tpu_torch.engine.runner_autoencoder \\
      --config cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml --steps 3

The CLI of the whole runner is ``python -m act_tpu_torch.main_autoencoder``.
Every entry point runs on the card unless ``--device cpu`` (``device="cpu"``)
is given.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.engine.serve import load_config, recon_forward
from act_tpu_torch.engine.train_state import (autoencoder_step, step_rngs, steps_per_epoch,
                                              timed_steps)
from act_tpu_torch.models import MODELS
from act_tpu_torch.parallel import (broadcast_module, data_count, gather_in_index_order,
                                    local_device, reduce_mean_scalar, tp)
from act_tpu_torch.utils.logger import print_log
from act_tpu_torch.utils.meters import AverageMeter
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


# arch -> (raw checkpoint prefix, the model's prefix): the layouts that
# torch_convert's load_timm_vit, load_clip_visual and load_hf_bert read
# (torch_convert.py:291-325); the JAX runner reads the timm one for every arch
TEACHER_KEYS = {
    "vit": (("blocks.", "visual_embed.0."), ("norm.", "visual_embed.1.")),
    "clip": (("visual.transformer.resblocks.", "visual_embed.1."),
             ("visual.ln_pre.", "visual_embed.0."), ("visual.ln_post.", "visual_embed.2.")),
    "bert": (("bert.encoder.layer.", "visual_embed.0.layer."),
             ("encoder.layer.", "visual_embed.0.layer.")),
}
TEACHER_FILES = {"vit": "a timm ViT", "clip": "an OpenAI CLIP model",
                 "bert": "a HuggingFace BERT"}


def load_teacher_weights(model: nn.Module, model_cfg, logger=None) -> int:
    """The 2D teacher's backbone from the ``.pth`` at ``model_cfg.teacher_ckpt``
    (``runner_autoencoder.py:52-83``), in the layout of the model's teacher
    arch (``TEACHER_KEYS``), by name and shape: a timm ViT's ``blocks.i.*``
    and ``norm.*``; CLIP's ``visual.transformer.resblocks.i.*``,
    ``visual.ln_pre.*`` and ``visual.ln_post.*``; HuggingFace BERT's
    ``[bert.]encoder.layer.i.*``. The rest of such a file (embeddings, heads,
    CLIP's text tower) has no place here. Without the file the teacher stays
    random, with a warning. Returns the tensors loaded."""
    if not getattr(model, "has_teacher", False):
        return 0
    arch = model.teacher_arch
    path = model_cfg.get("teacher_ckpt")
    if not path or not os.path.exists(str(path)):
        print_log("[AUTOENCODER][WARNING] no teacher_ckpt provided or found: the frozen "
                  f"{arch} teacher is RANDOMLY INITIALIZED (set model.teacher_ckpt to "
                  f"{TEACHER_FILES[arch]} .pth to reproduce the reference)", logger=logger)
        return 0
    if not str(path).endswith(".pth"):
        raise ValueError(f"teacher_ckpt {path}: the port reads {TEACHER_FILES[arch]} .pth "
                         "state dict")
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "model_state_dict"):
        if isinstance(payload, dict) and key in payload:
            payload = payload[key]
            break
    state = model.state_dict()
    n = 0
    with torch.no_grad():
        for k, v in payload.items():
            k = k.replace("module.", "")
            for src, dst in TEACHER_KEYS[arch]:
                if k.startswith(src):
                    name = dst + k[len(src):]
                    if name in state and tuple(state[name].shape) == tuple(v.shape):
                        state[name].copy_(v)
                        n += 1
                    break
    print_log(f"[AUTOENCODER] loaded {n} {arch} teacher tensors from {path}", logger=logger)
    return n


def prepare_model(cfg, seed: int, device, logger=None) -> nn.Module:
    """The config's dVAE from ``seed``, its teacher from ``teacher_ckpt``
    where there is one, frozen and cast as the JAX runner does it, on
    ``device``; under a tensor-parallel grid its teacher sharded
    (``runner_autoencoder.py:143-147``)."""
    model = build_autoencoder_model(cfg.model, seed)
    load_teacher_weights(model, cfg.model, logger)
    if getattr(model, "has_teacher", False) and bool(cfg.model.get("freeze_visual_embed", False)):
        builder.freeze_teacher_backbone(model, bool(cfg.model.get("frozen_bf16", True)))
    return tp.shard_module(model.to(device))


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
    dev = local_device(device)
    model = prepare_model(cfg, seed, dev)
    broadcast_module(model)
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


def _clouds_of(batch) -> Tuple[List[str], torch.Tensor]:
    """A loader batch (taxonomies, model ids, (B, N, 3) clouds) or one bare
    (N, 3) or (B, N, 3) cloud -> (a taxonomy a cloud, the clouds)."""
    if isinstance(batch, (tuple, list)) and len(batch) == 3:
        tax, _, data = batch
        pts = data[0] if isinstance(data, (tuple, list)) else data
        pts = torch.as_tensor(pts, dtype=torch.float32)
        tax = [tax] if isinstance(tax, str) else list(tax)
        return tax, pts.reshape(len(tax), -1, 3)
    pts = torch.as_tensor(batch, dtype=torch.float32)
    pts = pts.reshape(-1, pts.shape[-2], 3)
    return ["-"] * pts.shape[0], pts


def category_table(taxonomies: List[str], per_cloud: List[List[float]]
                   ) -> Tuple[Dict[str, Tuple[int, List[float]]], List[float]]:
    """{taxonomy: (clouds, mean of each metric)} in sorted order, and the
    Overall row: the mean over the categories of their means
    (``runner_autoencoder.py:327-336``)."""
    groups = defaultdict(list)
    for tax, row in zip(taxonomies, per_cloud):
        groups[tax].append(row)
    table = {tax: (len(rows), [float(np.mean(v)) for v in zip(*rows)])
             for tax, rows in sorted(groups.items())}
    overall = [float(np.mean(v)) for v in zip(*(m for _, m in table.values()))]
    return table, overall


def validate(model: nn.Module, batches: Iterable, consider_metric: str = "CDL1",
             max_batches: Optional[int] = None, logger=None
             ) -> Tuple[Metrics, List[List[float]]]:
    """Reconstruction metrics of ``model`` (eval mode, no grad) over
    ``batches``: loader batches (at B=1, as the reference validates) or
    bare clouds, each cloud a forward (``recon_forward``) and ``Metrics.get``
    of its whole fine reconstruction against it
    (``runner_autoencoder.py:307-337``). Prints the per-taxonomy table.
    Returns (the Overall metrics, the mean of the category means, with the
    table as ``.table``; each cloud's [F-Score, CDL1, CDL2]).

    Over several ranks each rank measures its share of a ``DataLoader``;
    the per-cloud rows and taxonomies of every rank are gathered, the
    padded repeats left out (``DataLoader.num_real``), and put back in the
    order of the index space (rank r's j-th cloud is position j*R + r), so
    the table and the rows are those of one rank over the same clouds."""
    model.eval()
    dev = next(model.parameters()).device
    taxonomies, per_cloud = [], []
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            tax, pts = _clouds_of(batch)
            for t, cloud in zip(tax, pts.to(dev)):
                fine = recon_forward(model, cloud[None])
                per_cloud.append(Metrics.get(fine[0], cloud))
                taxonomies.append(t)
    if data_count() > 1:
        taxonomies, per_cloud = _gather_clouds(batches, taxonomies, per_cloud)
    table, overall = category_table(taxonomies, per_cloud)
    print_log("============================ TEST RESULTS ============================",
              logger=logger)
    print_log("Taxonomy\t#Sample\t" + "\t".join(Metrics.names()), logger=logger)
    for tax, (n, means) in table.items():
        print_log(f"{tax}\t{n}\t" + "\t".join(f"{v:.4f}" for v in means), logger=logger)
    print_log("Overall\t\t" + "\t".join(f"{v:.4f}" for v in overall), logger=logger)
    metrics = Metrics(consider_metric, overall)
    metrics.table = table
    return metrics, per_cloud


def _gather_clouds(loader, taxonomies: List[str], per_cloud: List[List[float]]
                   ) -> Tuple[List[str], List[List[float]]]:
    """Every rank's clouds of ``validate`` without padded repeats, in the
    order of the loader's index space."""
    tax, rows = gather_in_index_order(loader, np.asarray(taxonomies, dtype=object),
                                      np.asarray(per_cloud, dtype=np.float64))
    return [str(t) for t in tax], [[float(v) for v in row] for row in rows]


@dataclass
class AutoencoderResult:
    """What ``run_net`` returns: the final model and optimizer, the best
    validation metrics, the train step and anneal iteration reached, the
    temperature and KLD weight of each step taken and the mean losses
    (x1000: recon, KLD) of each epoch run, and whether a preemption stopped
    the run."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    best_metrics: Optional[Metrics]
    step: int
    n_itr: int
    temps: List[float] = field(default_factory=list)
    kld_weights: List[float] = field(default_factory=list)
    epoch_losses: List[List[float]] = field(default_factory=list)
    preempted: bool = False


def _loaders(cfg, seed: int, num_workers: int, subsets):
    """The loaders of the named dataset nodes: train at ``total_bs``, the
    others at 1 (``main_autoencoder.py:46-47``)."""
    out = []
    for name in subsets:
        node = cfg.dataset[name]
        node.others.bs = int(cfg.total_bs) if name == "train" else 1
        out.append(builder.dataset_builder(node, seed, num_workers)[1])
    return out


def run_net(config, *, seed: int = 0, device="cuda", epochs: Optional[int] = None,
            max_steps: Optional[int] = None, max_val: Optional[int] = None,
            resume: bool = False, experiment_path: str = "experiments/autoencoder",
            num_workers: int = 0, val_freq: int = 1, train_writer=None,
            logger=None) -> AutoencoderResult:
    """The Stage-I run (``runner_autoencoder.py:105-287``): ``epochs`` epochs
    (default the config's ``max_epoch``; ``max_steps`` caps the batches of
    an epoch) through the ShapeNet-55 loader, the anneals at iteration
    ``n_itr`` (``start_epoch * len(train_loader)`` after a resume, one more
    each step), the lr schedule at ``len(train_loader)`` steps an epoch;
    then, when ``epoch % val_freq == 0`` (``runner_autoencoder.py:270``),
    ``validate`` (``max_val`` clouds, default all) and ckpt-best when the
    metrics are better; then ckpt-last, in ``experiment_path``.
    ``train_writer`` gets the step's reconstruction loss (x1000) at every
    100th batch of an epoch (``Loss/Batch/Recon`` at ``n_itr``,
    ``runner_autoencoder.py:250-252``). Once
    ``preemption.GUARD`` is set (checked after every step) it writes
    ckpt-last with the loader's cursor and returns with ``preempted`` set;
    ``resume`` re-enters that epoch at that batch, the anneals at
    ``start_epoch * len(train_loader) + start_batch``."""
    cfg = load_config(config)
    if epochs is not None:
        cfg.max_epoch = int(epochs)
    dev = local_device(device)
    train_loader, val_loader = _loaders(cfg, seed, num_workers, ("train", "val"))
    epoch_steps = max(len(train_loader), 1)
    model = prepare_model(cfg, seed, dev, logger)
    optimizer, schedule = builder.build_optimizer(cfg, model, epoch_steps)
    bnm = builder.build_bnm_schedule(cfg)
    clip = cfg.get("grad_norm_clip", None)
    named = {"train": train_loader, "val": val_loader}
    start_epoch, start_batch, step, best = 0, 0, 0, None
    if resume:
        start_epoch, step, best_d, start_batch = ckpt_lib.resume_state(model, optimizer,
                                                                       experiment_path, named)
        best = Metrics(cfg.consider_metric, best_d) if best_d else None
    broadcast_module(model)
    n_itr = start_epoch * epoch_steps + start_batch
    res = AutoencoderResult(model, optimizer, best, step, n_itr)
    n_step = 0
    try:
        for epoch in range(start_epoch, int(cfg.max_epoch)):
            first = start_batch if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, first)
            if bnm is not None:
                builder.set_bn_momentum(model, bnm(epoch))
            pending, t0 = [], time.time()
            for idx, (_, _, data) in enumerate(train_loader):
                pts = torch.as_tensor(data, dtype=torch.float32).to(dev)
                temp, kldw = get_temp(cfg, res.n_itr), get_kld_weight(cfg, res.n_itr)
                pending.append(autoencoder_step(model, optimizer, schedule, pts, res.step,
                                                step_rngs(seed, res.step, dev), temp, kldw,
                                                clip)[1:])
                res.temps.append(temp)
                res.kld_weights.append(kldw)
                res.step += 1
                res.n_itr += 1
                n_step += 1
                if train_writer is not None and idx % 100 == 0:
                    train_writer.add_scalar("Loss/Batch/Recon", float(pending[-1][0]) * 1000,
                                            res.n_itr)
                if GUARD.check(n_step):
                    ckpt_lib.save_checkpoint(
                        model, optimizer, res.step, epoch, None,
                        res.best_metrics.state_dict() if res.best_metrics else None,
                        "ckpt-last", experiment_path,
                        data_iter={"epoch": epoch, "next_batch": first + idx + 1},
                        loaders=named)
                    print_log(f"[PREEMPT] saved mid-epoch checkpoint at epoch {epoch} batch "
                              f"{first + idx + 1}; exiting gracefully", logger=logger)
                    res.preempted = True
                    return res
                if max_steps and idx + 1 >= max_steps:
                    break
            meters = AverageMeter(["Loss1", "Loss2"])
            for recon, kld in pending:  # one host fetch an epoch, not one a step
                meters.update([float(recon) * 1000, float(kld) * 1000])
            res.epoch_losses.append([reduce_mean_scalar(meters.avg(0)),
                                     reduce_mean_scalar(meters.avg(1))])
            print_log(f"[Epoch {epoch}] EpochTime={time.time() - t0:.1f}s "
                      f"Losses(x1000)={[f'{v:.4f}' for v in res.epoch_losses[-1]]} "
                      f"steps={len(pending)} n_itr={res.n_itr} lr={schedule(res.step):.6f}",
                      logger=logger)
            if epoch % val_freq == 0:
                metrics, _ = validate(model, val_loader, cfg.consider_metric, max_val, logger)
                if metrics.better_than(res.best_metrics):
                    res.best_metrics = metrics
                    ckpt_lib.save_checkpoint(model, optimizer, res.step, epoch,
                                             metrics.state_dict(), metrics.state_dict(),
                                             "ckpt-best", experiment_path)
            ckpt_lib.save_checkpoint(
                model, optimizer, res.step, epoch, None,
                res.best_metrics.state_dict() if res.best_metrics else None, "ckpt-last",
                experiment_path)
    finally:
        train_loader.close()
        val_loader.close()
    return res


def _eval_model(cfg, ckpts, seed: int, dev, logger=None) -> nn.Module:
    """The config's dVAE on ``dev`` with the weights of ``ckpts`` (a ``.pth``
    checkpoint or a state dict), or drawn from ``seed`` without one."""
    model = prepare_model(cfg, seed, dev, logger)
    if ckpts is not None:
        ckpt_lib.load_params_into(model, ckpts)
    broadcast_module(model)
    return model


def validate_net(config, *, ckpts=None, seed: int = 0, device="cuda",
                 max_batches: Optional[int] = None, logger=None) -> Metrics:
    """``--val``: the metrics of ``ckpts`` over the val split at B=1
    (``runner_autoencoder.py:340-352``)."""
    cfg = load_config(config)
    dev = local_device(device)
    (loader,) = _loaders(cfg, seed, 0, ("val",))
    return validate(_eval_model(cfg, ckpts, seed, dev, logger), loader,
                    cfg.consider_metric, max_batches, logger)[0]


def test_net(config, *, ckpts=None, seed: int = 0, device="cuda",
             experiment_path: str = "experiments/autoencoder",
             max_batches: Optional[int] = None, max_dumps: int = 20, logger=None) -> Metrics:
    """``--test``: the metrics of ``ckpts`` over the test split at B=1 and the
    first ``max_dumps`` reconstructions written to ``experiment_path/vis``
    (``runner_autoencoder.py:355-370``)."""
    cfg = load_config(config)
    dev = local_device(device)
    (loader,) = _loaders(cfg, seed, 0, ("test",))
    model = _eval_model(cfg, ckpts, seed, dev, logger)
    metrics = validate(model, loader, cfg.consider_metric, max_batches, logger)[0]
    dump_reconstructions(model, loader, os.path.join(experiment_path, "vis"), max_dumps, logger)
    return metrics


def dump_reconstructions(model: nn.Module, loader: Iterable, vis_dir: str,
                         max_dumps: int = 20, logger=None) -> List[str]:
    """Write the first cloud of each of the first ``max_dumps`` batches and
    its reconstruction (``recon_forward``) as ``{tax}_{n:03d}_gt.txt`` and
    ``_dense.txt`` at ``%.6f`` in ``vis_dir`` (``runner_autoencoder.py:373-406``,
    without the rendered images). Returns the file prefixes."""
    model.eval()
    dev = next(model.parameters()).device
    os.makedirs(vis_dir, exist_ok=True)
    prefixes = []
    with torch.no_grad():
        for batch in loader:
            if len(prefixes) >= max_dumps:
                break
            tax, pts = _clouds_of(batch)
            gt = pts[:1].to(dev)
            dense = recon_forward(model, gt)[0]
            prefix = os.path.join(vis_dir, f"{tax[0]}_{len(prefixes):03d}")
            np.savetxt(prefix + "_gt.txt", gt[0].cpu().numpy(), fmt="%.6f")
            np.savetxt(prefix + "_dense.txt", dense.float().cpu().numpy(), fmt="%.6f")
            prefixes.append(prefix)
    print_log(f"[TEST] dumped {len(prefixes)} reconstructions to {vis_dir}", logger=logger)
    return prefixes


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
