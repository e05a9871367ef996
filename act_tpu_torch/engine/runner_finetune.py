"""Classification finetune: train steps, validation, vote, test and checkpoints.

Counterpart of ``act_tpu/engine/runner_finetune.py:35-462`` (reference
tools/runner_finetune.py). A train step resamples each cloud by FPS to
``_point_all(npoints)`` points and keeps a random ``npoints`` of them in
random order (``ops.fps_subsample``), rotates it about y, and takes the CE
loss of ``PointTransformer`` in training mode, clipped AdamW at the CosLR
lr. Validation resamples by FPS to ``npoints`` and reports the overall
accuracy (OA) and the balanced accuracy (mAcc); the vote sums the softmax
of 10 resampled, scaled and shifted copies of each batch. Checkpoints are
``torch.save`` files in the reference layout (``engine/checkpoint.py``).
Over several ranks (``act_tpu_torch.parallel``) every rank trains on its
share of each global batch, validation, the vote and the test gather the
predictions and labels in rank order (padded repeats included, as in JAX),
the epoch's loss is the ranks' mean, and only rank 0 writes checkpoints.
``run_net`` polls the preemption guard (``engine/preemption.py``) after
every step. Under a tensor-parallel grid (``parallel/tp.py``) the model
is sharded over each model group and every forward, the evaluation's
included, runs through the shards; checkpoints keep the full layout. Not
ported: the TPU workarounds (``--h2d_dtype i16``, ``--scan_steps``, the
kernel mesh).

  python -m act_tpu_torch.engine.runner_finetune \\
      --config cfgs/finetune_classification/full/finetune_modelnet.yaml --steps 3
  python -m act_tpu_torch.engine.runner_finetune --config <yaml> --epochs 1 \\
      [--vote] [--ckpts <pretrained .pth>] [--resume] [--exp_dir <dir>]
  python -m act_tpu_torch.engine.runner_finetune --config <yaml> --test \\
      --ckpts <finetuned .pth> [--vote --rounds 300]

Every entry point runs on the card unless ``--device cpu`` (``device="cpu"``)
is given; the data fall back to the synthetic clouds when the configured
data root is absent.
"""
from __future__ import annotations

import argparse
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.datasets.transforms import rotate_y, scale_and_translate
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_state_dict
from act_tpu_torch.engine.train_state import finetune_step, step_rngs
from act_tpu_torch.models import MODELS
from act_tpu_torch.parallel import (broadcast_module, gather_concat, local_device,
                                    reduce_mean_scalar, tp)
from act_tpu_torch.utils.logger import print_log
from act_tpu_torch.utils.meters import AccMetric, AverageMeter, balanced_accuracy

VOTE_TIMES = 10
# the vote gate (reference runner_finetune.py:235): acc > 92.1 or (better and acc > 91)
VOTE_ALWAYS, VOTE_IF_BETTER = 92.1, 91.0


def _point_all(npoints: int) -> int:
    """FPS oversample count (reference runner_finetune.py:143-151)."""
    return {1024: 1200, 2048: 2400, 4096: 4800, 8192: 8192}.get(npoints, npoints)


def finetune_config(config, way: int = -1, shot: int = -1, fold: int = -1):
    """The config (a YAML path or a mapping) with the few-shot split: ``way``,
    ``shot`` and ``fold`` set on the train and val datasets when way and
    shot are given (``main.py:52-58``), and ``model.cls_dim`` set to
    ``way`` where it is unset or <= 0 (``runner_finetune.py:100-102``)."""
    cfg = load_config(config)
    if way != -1 and shot != -1:
        for name in ("train", "val"):
            cfg.dataset[name].others.update(way=int(way), shot=int(shot), fold=int(fold))
    if int(cfg.model.get("cls_dim", 0) or 0) <= 0:
        cfg.model.cls_dim = int(way)
    return cfg


def loaders(cfg, seed: int = 0, subsets=("train", "val"), num_workers: int = 0,
            device=None):
    """The loaders of the named dataset nodes: train at ``total_bs``, val and
    test at twice that (``runner_finetune.py:107-110, 395``), with
    ``num_workers`` forked workers for real data; a ModelNet tree without its
    FPS cache builds it on ``device``."""
    out = []
    for name in subsets:
        node = cfg.dataset[name]
        node.others.bs = int(cfg.total_bs) * (1 if name == "train" else 2)
        if device is not None:
            node.others.FPS_DEVICE = str(device)
        out.append(builder.dataset_builder(node, seed, num_workers)[1])
    return out


@dataclass
class FinetuneState:
    """The model in training, its optimizer, the lr schedule (step -> lr),
    the BN-momentum schedule (epoch -> momentum, or None) and the train
    transform's point count."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    bnm: Optional[Callable[[int], float]]
    npoints: int
    grad_norm_clip: Optional[float]


def build_state(cfg, epoch_steps: int, seed: int = 0, device="cuda",
                ckpts=None, strict: bool = False) -> FinetuneState:
    """``cfg.model`` with weights drawn from ``seed``, then the pretrained
    tensors of ``ckpts`` (a ``.pth`` path or a state dict; student prefixes
    lifted, merged by name and shape; with ``strict`` loaded as they are,
    every key of the model and no other) where given; the parameters that
    ``transfer_type`` does not train frozen and left out of AdamW; the lr
    schedule at ``epoch_steps`` steps an epoch; on ``device``. Under a
    tensor-parallel grid the model is sharded (``tp.shard_module``) before
    the optimizer is built (``runner_finetune.py:62-67, 87-91``)."""
    dev = local_device(device)
    with torch.device("meta"):
        model = MODELS.build(cfg.model)
    model = model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpts is not None and strict:
        model.load_state_dict(load_state_dict(ckpts), strict=True)
    elif ckpts is not None:
        ckpt_lib.merge_pretrained(model, ckpt_lib.strip_student_prefix(load_state_dict(ckpts)))
    builder.freeze_transfer(model, cfg.model.get("transfer_type", "full"))
    model = tp.shard_module(model.to(dev))
    optimizer, schedule = builder.build_optimizer(cfg, model, epoch_steps)
    return FinetuneState(model, optimizer, schedule, builder.build_bnm_schedule(cfg),
                         int(cfg.npoints), cfg.get("grad_norm_clip", None))


def train_transform(npoints: int) -> Callable[[torch.Tensor, torch.Generator], torch.Tensor]:
    """The train augment (reference runner_finetune.py:141-157 and :19-29):
    ``fps_subsample`` to ``npoints`` of ``_point_all(npoints)``, then a
    rotation about y, both drawn from the step's 'augment' generator."""
    def transform(pts: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return rotate_y(ops.fps_subsample(pts, _point_all(npoints), npoints, gen), gen)
    return transform


def train_step(st: FinetuneState, pts: torch.Tensor, labels: torch.Tensor, step: int,
               seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train step ``step`` of a run from ``seed``: the draws of the step come
    from ``step_rngs(seed, step)``. Returns (loss, acc), on the device."""
    dev = pts.device
    return finetune_step(st.model, st.optimizer, st.schedule, pts, labels, step,
                         step_rngs(seed, step, dev), train_transform(st.npoints),
                         st.grad_norm_clip)


def _to_device(batch, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    pts, labels = batch[2] if len(batch) == 3 else batch
    return (torch.as_tensor(pts, dtype=torch.float32).to(dev),
            torch.as_tensor(labels).to(dev))


@dataclass
class FinetuneRun:
    """What ``run_finetune_steps`` returns: the per-step losses and
    accuracies, the host ms of each step (each ending in a device
    synchronize), and the final state."""
    losses: List[float]
    accs: List[float]
    state: FinetuneState
    step_ms: List[float] = field(default_factory=list)


def run_finetune_steps(config, steps: int, *, batches: Optional[Iterable] = None,
                       seed: int = 0, device="cuda", state: Optional[FinetuneState] = None,
                       start_step: int = 0) -> FinetuneRun:
    """Take ``steps`` finetune train steps of ``config`` (a YAML path or a
    mapping) and return the losses and the final state.

    ``batches``: (points (B, N, 3), labels (B,)) pairs or loader batches,
    one a step; by default the train split's loader, epoch after epoch.
    ``state`` continues a run (``build_state``, ``resume_state``) at step
    ``start_step``. Every step ends in a device synchronize, so its host time
    is the step's time."""
    cfg = finetune_config(config)
    dev = local_device(device)
    (train_loader,) = loaders(cfg, seed, ("train",), device=dev)
    if batches is None:
        def from_loader():
            for epoch in range(math.ceil(steps / max(len(train_loader), 1))):
                train_loader.set_epoch(epoch)
                yield from train_loader
        batches = from_loader()
    if state is None:
        st = build_state(cfg, max(len(train_loader), 1), seed, dev)
        broadcast_module(st.model)
    else:
        st = state
    losses, accs, step_ms = [], [], []
    for i, batch in zip(range(steps), batches):
        pts, labels = _to_device(batch, dev)
        t0 = time.perf_counter()
        loss, acc = train_step(st, pts, labels, start_step + i, seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        accs.append(acc)
    return FinetuneRun([float(x) for x in losses], [float(x) for x in accs], st, step_ms)


def _model_device(model: nn.Module, device) -> torch.device:
    """``device`` resolved (the card unless "cpu"), and the model on it."""
    dev = local_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"the model is on {next(model.parameters()).device}, not {dev}")
    return next(model.parameters()).device


def predict(model: nn.Module, loader: Iterable, npoints: int, device="cuda"
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The eval protocol's logits: each batch resampled by FPS to ``npoints``
    (``runner_finetune.py:153-156``), then the eval forward, on ``device``
    (the model's). Returns (f32 logits (n, cls_dim), labels (n,)), every
    rank's in rank order (``runner_finetune.py:299-308``)."""
    dev = _model_device(model, device)
    model.eval()
    infer = build_infer_fn(model, npoints)
    logits, labels = [], []
    for batch in loader:
        pts, label = _to_device(batch, dev)
        logits.append(infer(pts).float().cpu().numpy())
        labels.append(label.cpu().numpy())
    return gather_concat(np.concatenate(logits)), gather_concat(np.concatenate(labels))


def validate(model: nn.Module, loader: Iterable, npoints: int, device="cuda",
             logger=None) -> AccMetric:
    """OA (%) over ``loader``, with the mAcc (%) as ``.macc``
    (``runner_finetune.py:312-321``)."""
    logits, labels = predict(model, loader, npoints, device)
    preds = logits.argmax(-1)
    metric = AccMetric(float((preds == labels).mean()) * 100.0,
                       balanced_accuracy(labels, preds) * 100.0)
    print_log(f"[VALIDATION] OA = {metric.acc:.4f}  mAcc = {metric.macc:.4f}", logger)
    return metric


def vote_generator(seed: int, vote_round: int, batch: int, device) -> torch.Generator:
    """The generator of the votes of batch ``batch`` in round ``vote_round``,
    seeded from (seed, round, batch) as ``step_rngs`` seeds a step."""
    words = np.random.SeedSequence([seed, vote_round, batch]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(words[0]) << 32) | int(words[1]))


def vote_logits(model: nn.Module, pts: torch.Tensor, npoints: int,
                generator: torch.Generator, times: int = VOTE_TIMES) -> torch.Tensor:
    """The sum over ``times`` votes of softmax(logits) of ``pts`` (B, N, 3)
    resampled by ``fps_subsample`` and scaled and shifted, all drawn from
    ``generator`` (``runner_finetune.py:324-358``); eval mode."""
    acc = None
    for _ in range(times):
        p = ops.fps_subsample(pts, _point_all(npoints), npoints, generator)
        prob = torch.softmax(model(scale_and_translate(p, generator)), dim=-1)
        acc = prob if acc is None else acc + prob
    return acc


def validate_vote(model: nn.Module, loader: Iterable, npoints: int, seed: int = 0,
                  times: int = VOTE_TIMES, vote_round: int = 0, device="cuda",
                  logger=None) -> float:
    """OA (%) of the vote over ``loader`` on ``device`` (the model's)
    (reference validate_vote, runner_finetune.py:300-365), batch i's draws
    from ``vote_generator(seed, vote_round, i)``; the predictions of every
    rank in rank order (``runner_finetune.py:365-381``)."""
    dev = _model_device(model, device)
    model.eval()
    preds, labels = [], []
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            pts, label = _to_device(batch, dev)
            gen = vote_generator(seed, vote_round, i, dev)
            preds.append(vote_logits(model, pts, npoints, gen, times).argmax(-1).cpu().numpy())
            labels.append(label.cpu().numpy())
    preds = gather_concat(np.concatenate(preds))
    labels = gather_concat(np.concatenate(labels))
    acc = float((preds == labels).mean()) * 100.0 if len(preds) else 0.0
    print_log(f"[VOTE] acc = {acc:.4f} ({times} votes)", logger)
    return acc


def test_vote_rounds(model: nn.Module, loader: Iterable, npoints: int, seed: int,
                     rounds: int, times: int = VOTE_TIMES, device="cuda",
                     logger=None) -> np.ndarray:
    """Per-round vote OA (%) of the best-of-N test protocol (reference
    runner_finetune.py:425-432): round r is ``validate_vote`` at
    ``vote_round=r``. ``loader`` is iterated once a round."""
    return np.array([validate_vote(model, loader, npoints, seed, times, r, device, logger)
                     for r in range(rounds)], dtype=np.float64)


@dataclass
class FinetuneResult:
    """What ``run_net`` returns: the final state, the best validation
    metric, the mean loss and accuracy of each epoch, the steps taken."""
    state: FinetuneState
    best_metrics: AccMetric
    epoch_loss: List[float]
    epoch_acc: List[float]
    steps: int
    preempted: bool = False


def run_net(config, *, seed: int = 0, device="cuda", epochs: Optional[int] = None,
            max_steps: Optional[int] = None, vote: bool = False, ckpts=None,
            resume: bool = False, experiment_path: str = "experiments/finetune",
            way: int = -1, shot: int = -1, fold: int = -1, num_workers: int = 0,
            val_freq: int = 1, logger=None) -> FinetuneResult:
    """The finetune run (``runner_finetune.py:95-295``): ``epochs`` epochs
    (default the config's ``max_epoch``; ``max_steps`` caps the batches of
    an epoch), each followed, when ``epoch % val_freq == 0`` (``--val_freq``,
    ``runner_finetune.py:265``), by a validation with ckpt-best and the vote
    behind its gate with ckpt-best_vote, then by ckpt-last (the reference
    runner's cadence). ``ckpts`` starts from pretrained weights;
    ``resume`` continues from the ckpt-last of ``experiment_path``, inside
    the interrupted epoch after a preemption save; ``way``, ``shot``,
    ``fold`` pick a few-shot split (``finetune_config``); ``num_workers``
    forked workers load real data; the run's lines go to ``logger``
    (``utils/logger.print_log``). Once ``preemption.GUARD`` is set (checked
    after every step) it writes ckpt-last with the loader's cursor and
    returns with ``preempted`` set."""
    cfg = finetune_config(config, way, shot, fold)
    if epochs is not None:
        cfg.max_epoch = int(epochs)
    dev = local_device(device)
    train_loader, val_loader = loaders(cfg, seed, num_workers=num_workers, device=dev)
    try:
        named = {"train": train_loader, "val": val_loader}
        st = build_state(cfg, max(len(train_loader), 1), seed, dev, None if resume else ckpts)
        start_epoch, start_batch, step, best = 0, 0, 0, AccMetric(0.0)
        if resume:
            start_epoch, step, best_d, start_batch = ckpt_lib.resume_state(
                st.model, st.optimizer, experiment_path, named)
            if best_d:
                best = AccMetric(best_d.get("acc", 0.0))
        broadcast_module(st.model)
        res = FinetuneResult(st, best, [], [], step)
        n_step = 0
        for epoch in range(start_epoch, int(cfg.max_epoch)):
            first = start_batch if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, first)
            if st.bnm is not None:
                builder.set_bn_momentum(st.model, st.bnm(epoch))
            meters, pending, t0 = AverageMeter(["loss", "acc"]), [], time.time()
            for idx, batch in enumerate(train_loader):
                pts, labels = _to_device(batch, dev)
                pending.append(train_step(st, pts, labels, res.steps, seed))
                res.steps += 1
                n_step += 1
                if GUARD.check(n_step):
                    ckpt_lib.save_checkpoint(
                        st.model, st.optimizer, res.steps, epoch, None,
                        res.best_metrics.state_dict(), "ckpt-last", experiment_path,
                        data_iter={"epoch": epoch, "next_batch": first + idx + 1},
                        loaders=named)
                    print_log(f"[PREEMPT] saved mid-epoch checkpoint at epoch {epoch} batch "
                              f"{first + idx + 1}; exiting gracefully", logger)
                    res.preempted = True
                    return res
                if max_steps and idx + 1 >= max_steps:
                    break
            for loss, acc in pending:  # one host fetch an epoch, not one a step
                meters.update([float(loss), float(acc)])
            loss, acc = reduce_mean_scalar(meters.avg(0)), reduce_mean_scalar(meters.avg(1))
            res.epoch_loss.append(loss)
            res.epoch_acc.append(acc)
            print_log(f"[Epoch {epoch}] time={time.time() - t0:.1f}s loss={loss:.4f} "
                      f"acc={acc:.2f} lr={st.schedule(res.steps):.6f}", logger)
            if epoch % val_freq == 0:
                acc = validate(st.model, val_loader, st.npoints, dev, logger)
                better = acc.better_than(res.best_metrics)
                if better:
                    res.best_metrics = acc
                    ckpt_lib.save_checkpoint(st.model, st.optimizer, res.steps, epoch,
                                             acc.state_dict(), acc.state_dict(), "ckpt-best",
                                             experiment_path)
                if vote and (acc.acc > VOTE_ALWAYS or (better and acc.acc > VOTE_IF_BETTER)):
                    vote_acc = validate_vote(st.model, val_loader, st.npoints, seed, device=dev,
                                             logger=logger)
                    if vote_acc > res.best_metrics.acc:
                        ckpt_lib.save_checkpoint(
                            st.model, st.optimizer, res.steps, epoch, {"acc": vote_acc},
                            res.best_metrics.state_dict(), "ckpt-best_vote", experiment_path)
            ckpt_lib.save_checkpoint(st.model, st.optimizer, res.steps, epoch, None,
                                     res.best_metrics.state_dict(), "ckpt-last",
                                     experiment_path)
    finally:
        train_loader.close()
        val_loader.close()
    return res


class FirstBatches:
    """The first ``n`` batches of ``loader`` (all of them for None), each
    time it is iterated."""

    def __init__(self, loader: Iterable, n: Optional[int]):
        self.loader, self.n = loader, n

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)


def test_net(config, *, ckpts=None, seed: int = 0, device="cuda", vote: bool = False,
             rounds: int = 300, way: int = -1, num_workers: int = 0,
             max_batches: Optional[int] = None, strict: bool = False,
             logger=None) -> AccMetric:
    """Test OA of the weights in ``ckpts`` (``runner_finetune.py:387-423``);
    with ``vote`` also the best of ``rounds`` vote rounds as ``.vote``.
    ``max_batches`` keeps the first test batches; ``strict`` loads ``ckpts``
    as a whole model (``build_state``)."""
    cfg = finetune_config(config, way)
    dev = local_device(device)
    (loader,) = loaders(cfg, seed, ("test",), num_workers, dev)
    test_loader = FirstBatches(loader, max_batches)
    try:
        st = build_state(cfg, 1, seed, dev, ckpts, strict)
        broadcast_module(st.model)
        acc = validate(st.model, test_loader, st.npoints, dev, logger)
        print_log(f"[TEST] OA = {acc.acc:.4f}", logger)
        if vote:
            best = 0.0
            for r, a in enumerate(test_vote_rounds(st.model, test_loader, st.npoints, seed,
                                                   rounds, device=dev, logger=logger)):
                best = max(best, float(a))
                print_log(f"[TEST_VOTE] round {r} acc={a:.4f} best={best:.4f}", logger)
            acc.vote = best
    finally:
        loader.close()
    return acc


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="cfgs/finetune_classification/full/finetune_modelnet.yaml")
    ap.add_argument("--steps", type=int, default=None,
                    help="take this many train steps and stop (no validation)")
    ap.add_argument("--epochs", type=int, default=None, help="epochs of run_net")
    ap.add_argument("--vote", action="store_true")
    ap.add_argument("--rounds", type=int, default=300, help="vote rounds of --test")
    ap.add_argument("--ckpts", default=None, help="pretrained (or, with --test, finetuned) .pth")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--exp_dir", default="experiments/finetune")
    ap.add_argument("--way", type=int, default=-1, help="few-shot classes (cls_dim where unset)")
    ap.add_argument("--shot", type=int, default=-1)
    ap.add_argument("--fold", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.test:
        acc = test_net(args.config, ckpts=args.ckpts, seed=args.seed, device=args.device,
                       vote=args.vote, rounds=args.rounds, way=args.way)
        print(f"test OA {acc.acc:.4f}, mAcc {acc.macc:.4f}"
              + (f", best vote {acc.vote:.4f}" if args.vote else ""))
    elif args.epochs is None:
        run = run_finetune_steps(args.config, 3 if args.steps is None else args.steps,
                                 seed=args.seed, device=args.device)
        for i, ms in enumerate(run.step_ms):
            print(f"step {i}: loss {run.losses[i]:.6f}, acc {run.accs[i]:.2f}, {ms:.1f} ms")
    else:
        res = run_net(args.config, seed=args.seed, device=args.device, epochs=args.epochs,
                      max_steps=args.steps, vote=args.vote, ckpts=args.ckpts,
                      resume=args.resume, experiment_path=args.exp_dir, way=args.way,
                      shot=args.shot, fold=args.fold)
        print(f"{res.steps} steps; best OA {res.best_metrics.acc:.4f}")


if __name__ == "__main__":
    main()
