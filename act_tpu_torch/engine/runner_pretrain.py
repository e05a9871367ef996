"""Stage-II pretraining entry points: train ACT_PointDistillation or
ACT_PointBERT with the linear-SVM probe and checkpoints.

Counterpart of ``act_tpu/engine/runner_pretrain.py`` (reference
tools/runner_pretrain.py): build the model from the YAML, draw the weights
from a seed, load the Stage-I dVAE from ``dvae_config.ckpt`` (a ``.pth``: the
port's Stage-I checkpoint or a reference one) into the tokenizer
(``dvae_tokenizer``, or ``dvae`` for ACT_PointBERT), freeze the tokenizer and
store its matmul weights in bf16, build AdamW with CosLR, and
train on the ShapeNet-55 loader (or ModelNet, resampled by FPS first). Each
epoch ends in the SVM probe on the student's features of the ModelNet40
``extra_train`` and ``val`` splits, ckpt-best on its accuracy, ckpt-last,
and from epoch 250 a ``ckpt-epoch-NNN`` every 25 epochs. ``resume``
continues from ckpt-last; ``start_ckpts`` starts from a checkpoint's weights.
``run_steps`` takes train steps on given batches or on the synthetic clouds,
without loader or checkpoints. For ACT_PointBERT (``runner_pretrain.py:170-192,
234-238``) the k encoder starts as a copy of the q encoder and is frozen
beside the tokenizer (only the tokenizer is stored in bf16), every step ends
in the EMA of k at ``model.m``, and the checkpoints carry the MoCo queue and
its pointer (buffers of the model's state dict). Over several ranks
(``act_tpu_torch.parallel``) each rank trains on its share of the global
batch, the probe's features are gathered in rank order, the epoch's loss is
the ranks' mean and only rank 0 writes checkpoints; ACT_PointBERT's step is
the one-process step on the global batch (its mixup partners, replacement
tokens and MoCo keys are gathered over the ranks, ``models/act.py``), so
its queue and k encoder stay equal on every rank. ``run_net`` polls the
preemption guard (``engine/preemption.py``) after every step. Not ported:
the TPU workarounds (``--scan_steps``, ``--h2d_dtype``, the kernel mesh).

  python -m act_tpu_torch.engine.runner_pretrain \\
      --config cfgs/pretrain/pretrain_act_distill.yaml --steps 3

The CLI of the whole runner is ``python -m act_tpu_torch.main``. Every entry
point runs on the card unless ``--device cpu`` (``device="cpu"``) is given.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.datasets.transforms import scale_and_translate
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.engine.serve import (Checkpoint, build_features_fn, load_config,
                                        load_state_dict)
from act_tpu_torch.engine.train_state import (pretrain_step, step_rngs, steps_per_epoch,
                                              timed_steps)
from act_tpu_torch.models import MODELS
from act_tpu_torch.parallel import (broadcast_module, gather_concat, local_device,
                                    reduce_mean_scalar, tp)
from act_tpu_torch.utils.logger import print_log
from act_tpu_torch.utils.meters import AccMetric, AverageMeter
from act_tpu_torch.utils.profiling import StepTimer, TraceContext
from act_tpu_torch.utils.svm import LinearSVC

TOKENIZER = "dvae_tokenizer"
# the frozen Stage-I tokenizer's name in each pretrain model
TOKENIZERS = {"ACT_PointDistillation": TOKENIZER, "ACT_PointBERT": "dvae"}
MOMENTUM_ENCODER = "transformer_k"  # ACT_PointBERT's EMA copy of transformer_q
LOG_EVERY = 100  # batches between run_net's batch lines (runner_pretrain.py:364-372)


def tokenizer_name(model_cfg) -> str:
    """The tokenizer submodule of the pretrain model ``model_cfg`` names."""
    if model_cfg.NAME not in TOKENIZERS:
        raise ValueError(f"{model_cfg.NAME} is not a pretrain model ({sorted(TOKENIZERS)})")
    return TOKENIZERS[model_cfg.NAME]


def is_pointbert(model_cfg) -> bool:
    return model_cfg.NAME == "ACT_PointBERT"


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
    """``model_cfg`` built on the CPU with weights from ``seed`` (ACT_PointBERT's
    k encoder then a copy of its q encoder, ``copy_query_encoder``), or from
    a reference state dict / ``.pth`` (its tokenizer's Stage-I ``decoder.*``
    keys are dropped, every other key must match)."""
    stage_one_keys = f"{tokenizer_name(model_cfg)}.decoder."  # FoldingNet, not built here
    with torch.device("meta"):
        model = MODELS.build(model_cfg)
    model = model.to_empty(device="cpu")
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
        if is_pointbert(model_cfg):
            copy_query_encoder(model)
    else:
        sd = {k: v for k, v in load_state_dict(state_dict).items()
              if not k.startswith(stage_one_keys)}
        model.load_state_dict(sd, strict=True)
    return model


def freeze_tokenizer(model: nn.Module, cfg) -> nn.Module:
    """The tokenizer frozen, its matmul weights stored in bf16 unless the
    config sets ``model.frozen_bf16: false``; returns ``model``. For
    ACT_PointBERT the k encoder is also frozen (it moves by EMA only) and
    stays f32."""
    tok = tokenizer_name(cfg.model)
    builder.freeze(model, [tok] + ([MOMENTUM_ENCODER] if is_pointbert(cfg.model) else []))
    if bool(cfg.model.get("frozen_bf16", True)):
        builder.cast_frozen_bf16(model, [tok])
    return model


def copy_query_encoder(model: nn.Module) -> nn.Module:
    """ACT_PointBERT's k encoder parameters set to a copy of the q encoder's
    (``runner_pretrain.py:182-189``; reference models/act.py:939-942); the
    BatchNorm statistics stay each encoder's own. Returns ``model``."""
    q = dict(model.transformer_q.named_parameters())
    with torch.no_grad():
        for name, p in model.transformer_k.named_parameters():
            p.copy_(q[name])
    return model


def ema_momentum(cfg) -> Optional[float]:
    """The EMA momentum of the config's train step: ``model.m`` for
    ACT_PointBERT, else None."""
    return float(cfg.model.m) if is_pointbert(cfg.model) else None


def run_steps(config, steps: int, *, batches: Optional[Iterable] = None, seed: int = 0,
              device="cuda", state_dict: Optional[Checkpoint] = None) -> PretrainRun:
    """Take ``steps`` Stage-II train steps of ``config`` (a YAML path or a
    mapping) and return the losses and the final state.

    ``batches``: (B, N, 3) clouds, one a step; by default the synthetic
    ShapeNet-55 clouds at ``total_bs`` x ``npoints``. The lr schedule counts
    ``512 // total_bs`` steps an epoch, as the JAX runner does on those
    clouds. Every step ends in a device synchronize, so its host time is
    the step's time. An ACT_PointBERT step's loss is the sum of its three."""
    cfg = load_config(config)
    dev = local_device(device)
    model = freeze_tokenizer(build_pretrain_model(cfg.model, seed, state_dict), cfg).to(dev)
    broadcast_module(tp.shard_module(model))
    optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
    clip, m = cfg.get("grad_norm_clip", None), ema_momentum(cfg)
    losses, step_ms = timed_steps(
        lambda step, pts: pretrain_step(model, optimizer, schedule, pts, step,
                                        step_rngs(seed, step, dev), grad_norm_clip=clip,
                                        ema_momentum=m),
        steps, cfg, batches, dev)
    return PretrainRun([float(x) for x in losses], model, optimizer, step_ms)


def load_dvae_ckpt(model: nn.Module, dvae_cfg, allow_random: bool = False,
                   logger=None, tokenizer: str = TOKENIZER) -> int:
    """The frozen Stage-I tokenizer from ``dvae_config.ckpt`` into the
    submodule ``tokenizer`` of ``model`` (``dvae`` for ACT_PointBERT;
    ``runner_pretrain.py:46-104``; reference
    build_tokenizer, models/act.py:1151-1160). Call it before
    ``cast_frozen_bf16``: the tensors load into the f32 parameters.

    The file is a ``.pth``: the port's Stage-I checkpoint (its ``base_model``
    keys carry no prefix) or a reference one with ``base_model`` dVAE keys;
    its ``decoder.*`` keys are dropped (Stage II's tokenizer has no decoder)
    and every tokenizer key must be there. A set but absent path raises
    ``FileNotFoundError`` unless ``allow_random``; an unset path warns; in
    both cases the tokenizer stays random. Returns the tensors loaded."""
    path = dvae_cfg.get("ckpt") if hasattr(dvae_cfg, "get") else None
    if not path:
        print_log("[PRETRAIN][WARNING] dvae_config.ckpt not set: the frozen tokenizer and "
                  "teacher are RANDOMLY INITIALIZED", logger=logger)
        return 0
    if not os.path.exists(path):
        if not allow_random:
            raise FileNotFoundError(
                f"dvae_config.ckpt = '{path}' does not exist. The reference loads the "
                "Stage-I tokenizer strictly (models/act.py:1151-1160); pretraining against "
                "a random tokenizer is meaningless. Fix the path, or pass "
                "--allow_random_tokenizer to proceed anyway.")
        print_log(f"[PRETRAIN][WARNING] dvae ckpt '{path}' not found: the frozen tokenizer "
                  "and teacher are RANDOMLY INITIALIZED", logger=logger)
        return 0
    if os.path.isdir(path) or not str(path).endswith(".pth"):
        raise ValueError(f"dvae_config.ckpt = '{path}': the port reads a .pth checkpoint "
                         "(the port's Stage-I ckpt-best.pth or a reference .pth), not an "
                         f"orbax directory; {ckpt_lib.BRIDGE_HINT}")
    loaded = {k: v for k, v in load_state_dict(path).items() if not k.startswith("decoder.")}
    tokenizer = getattr(model, tokenizer)
    want = tokenizer.state_dict()
    missing = sorted(set(want) - set(loaded))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} tokenizer tensors: {missing}")
    unexpected = sorted(set(loaded) - set(want))
    tokenizer.load_state_dict({k: loaded[k] for k in want}, strict=True)
    print_log(f"[PRETRAIN] loaded the frozen dVAE tokenizer from {path}: {len(want)} tensors"
              + (f"; ignored {unexpected}" if unexpected else ""), logger=logger)
    return len(want)


def prepare_model(cfg, seed: int, device, allow_random_tokenizer: bool = False,
                  logger=None) -> nn.Module:
    """The config's model from ``seed`` with the Stage-I tokenizer of
    ``dvae_config.ckpt`` (``load_dvae_ckpt``), the tokenizer frozen and its
    matmul weights stored in bf16 (ACT_PointBERT: k a frozen f32 copy of
    q), on ``device``; under a tensor-parallel grid sharded, the
    tokenizer's teacher and PointBERT's k encoder too
    (``runner_pretrain.py:193-198``)."""
    model = build_pretrain_model(cfg.model, seed)
    load_dvae_ckpt(model, cfg.model.dvae_config, allow_random_tokenizer, logger,
                   tokenizer_name(cfg.model))
    return tp.shard_module(freeze_tokenizer(model, cfg).to(device))


def evaluate_svm(train_features, train_labels, test_features, test_labels,
                 device=None, logger=None) -> Tuple[float, LinearSVC]:
    """The linear probe (``runner_pretrain.py:37-43``, reference
    evaluate_svm): ``LinearSVC`` fitted on the train features, the fraction
    of test labels it predicts; on ``device`` (default the CPU). Returns
    (accuracy in [0, 1], the fitted probe)."""
    clf = LinearSVC().fit(train_features, train_labels, device=device)
    pred = clf.predict(test_features)
    acc = float(np.sum(np.asarray(test_labels).reshape(-1) == pred) / pred.shape[0])
    print_log(f"[SVM] {len(clf.classes_)} classes, {len(pred)} test features: "
              f"{clf.n_iter_} Newton iterations, relative gradient norm {clf.rel_grad_:.3e}",
              logger=logger)
    return acc, clf


def probe_features(model: nn.Module, loader: Iterable, npoints: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The student's cls features of every cloud of ``loader`` (the JAX
    runner's ``feat_step``, ``runner_pretrain.py:272-282``): each batch
    resampled by FPS + gather to ``npoints`` when it has another point
    count, then ``forward_eval`` in eval mode (``build_features_fn``); the model's
    mode is restored afterwards. Returns (f32 features (n, cls_dim), labels
    (n,)), every rank's in rank order (``runner_pretrain.py:436-440``)."""
    was_training = model.training
    features = build_features_fn(model.eval(), npoints)
    feats, labels = [], []
    try:
        for _, _, (pts, label) in loader:
            feats.append(features(pts).float().cpu().numpy())
            labels.append(np.asarray(label).reshape(-1))
    finally:
        model.train(was_training)
    return gather_concat(np.concatenate(feats)), gather_concat(np.concatenate(labels))


def validate(model: nn.Module, extra_train_loader: Iterable, test_loader: Iterable,
             npoints: int, epoch: int = -1, logger=None) -> AccMetric:
    """The SVM probe on the student's features (``runner_pretrain.py:421-444``):
    accuracy (%), with the probe's Newton iterations and final relative
    gradient norm as ``.svm_iters`` and ``.svm_rel_grad``."""
    dev = next(model.parameters()).device
    train_f, train_l = probe_features(model, extra_train_loader, npoints)
    test_f, test_l = probe_features(model, test_loader, npoints)
    acc, clf = evaluate_svm(train_f, train_l, test_f, test_l, dev, logger)
    metric = AccMetric(acc * 100.0)
    metric.svm_iters, metric.svm_rel_grad = clf.n_iter_, clf.rel_grad_
    print_log(f"[VALIDATION] epoch {epoch} linear-probe acc = {metric.acc:.4f}", logger=logger)
    return metric


def pretrain_transform(dataset, npoints: int) -> Callable:
    """The train augment of the dataset (``runner_pretrain.py:220-231``):
    ShapeNet clouds come subsampled and are scaled and shifted; ModelNet
    clouds are first resampled by FPS + gather to ``npoints``."""
    if type(dataset).__name__ != "ModelNet":
        return scale_and_translate

    def transform(pts: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return scale_and_translate(
            ops.gather_coords(pts, ops.furthest_point_sample(pts, npoints)), gen)
    return transform


def is_snapshot_epoch(epoch: int) -> bool:
    """Epochs that keep a ``ckpt-epoch-NNN`` (``runner_pretrain.py:410-413``)."""
    return epoch % 25 == 0 and epoch >= 250


@dataclass
class PretrainResult:
    """What ``run_net`` returns: the final model and optimizer, the best
    probe accuracy, the train step reached, each epoch's mean loss and each
    probe's accuracy, and whether a preemption stopped the run."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    best_metrics: AccMetric
    step: int
    epoch_loss: List[float] = field(default_factory=list)
    probes: List[AccMetric] = field(default_factory=list)
    preempted: bool = False


def run_net(config, *, seed: int = 0, device="cuda", epochs: Optional[int] = None,
            max_steps: Optional[int] = None, resume: bool = False,
            start_ckpts: Optional[str] = None, experiment_path: str = "experiments/pretrain",
            allow_random_tokenizer: bool = False, num_workers: int = 0,
            val_freq: int = 1, train_writer=None, logger=None) -> PretrainResult:
    """The Stage-II run (``runner_pretrain.py:136-418``): ``epochs`` epochs
    (default the config's ``max_epoch``; ``max_steps`` caps the batches of
    an epoch) of the train split at ``total_bs``, the lr schedule at
    ``len(train_loader)`` steps an epoch, step ``i``'s draws from
    ``step_rngs(seed, i)``; after each epoch with ``epoch % val_freq == 0``
    (``runner_pretrain.py:394-395``) the SVM probe over the ``extra_train``
    and ``val`` splits at twice ``total_bs`` with ckpt-best on its accuracy;
    after every epoch ckpt-last, and ``ckpt-epoch-NNN`` every 25 epochs from
    epoch 250, in ``experiment_path``. ACT_PointBERT's steps end in the EMA
    of its k encoder, and its checkpoints carry the queue and its pointer,
    which ``resume`` restores with the weights. Once ``preemption.GUARD`` is
    set (checked after every step) it writes ckpt-last with the loader's
    cursor and returns with ``preempted`` set; ``resume`` re-enters that
    epoch at that batch. At every ``LOG_EVERY``-th batch of an epoch
    (batches 1, 101, ...) it prints JAX's line ``[Epoch e][Batch i/n]
    BatchTime=...s Loss=... lr=...`` (``runner_pretrain.py:364-372``: the
    ``StepTimer``'s mean, the running mean of the epoch's losses, fetched
    from the device only there and at the epoch's end) and ``train_writer``
    gets the step's loss and lr (``Loss/Batch/Loss``, ``Loss/Batch/LR`` at
    the steps taken, ``runner_pretrain.py:373-375``). With
    ``ACT_TPU_PROFILE`` set, steps [10, 15) of the run are traced
    (``utils/profiling.TraceContext``, ``runner_pretrain.py:289-291, 331``);
    a preemption or the run's end closes an open window."""
    cfg = load_config(config)
    if epochs is not None:
        cfg.max_epoch = int(epochs)
    dev = local_device(device)
    probe = "val" in cfg.dataset and "extra_train" in cfg.dataset
    for name in ("train", "val", "extra_train") if probe else ("train",):
        cfg.dataset[name].others.bs = (1 if name == "train" else 2) * int(cfg.total_bs)
        cfg.dataset[name].others.FPS_DEVICE = str(dev)  # where a ModelNet cache is built
    train_set, train_loader = builder.dataset_builder(cfg.dataset.train, seed, num_workers)
    if probe:
        val_loader = builder.dataset_builder(cfg.dataset.val, seed, num_workers)[1]
        extra_loader = builder.dataset_builder(cfg.dataset.extra_train, seed, num_workers)[1]
        val_npoints = int(cfg.dataset.val.others.npoints)
    npoints = int(cfg.dataset.train.others.npoints)
    model = prepare_model(cfg, seed, dev, allow_random_tokenizer, logger)
    epoch_steps = max(len(train_loader), 1)
    optimizer, schedule = builder.build_optimizer(cfg, model, epoch_steps)
    bnm = builder.build_bnm_schedule(cfg)
    clip, m = cfg.get("grad_norm_clip", None), ema_momentum(cfg)
    named = {"train": train_loader}
    if probe:
        named.update(val=val_loader, extra_train=extra_loader)
    start_epoch, start_batch, step, best = 0, 0, 0, AccMetric(0.0)
    if resume:
        start_epoch, step, best_d, start_batch = ckpt_lib.resume_state(model, optimizer,
                                                                       experiment_path, named)
        if best_d:
            best = AccMetric(best_d.get("acc", 0.0))
    elif start_ckpts:
        ckpt_lib.load_params_into(model, start_ckpts)
    broadcast_module(model)
    transform = pretrain_transform(train_set, npoints)
    res = PretrainResult(model, optimizer, best, step)
    print_log(f"[PRETRAIN] {cfg.model.NAME}: {epoch_steps} steps/epoch, "
              f"{int(cfg.max_epoch)} epochs", logger=logger)
    trace = TraceContext(device=dev)
    try:
        n_step = 0
        for epoch in range(start_epoch, int(cfg.max_epoch)):
            first = start_batch if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, first)
            if bnm is not None:
                builder.set_bn_momentum(model, bnm(epoch))
            meters, timer = AverageMeter(["Loss"]), StepTimer()
            pending, fetched, t0 = [], 0, time.time()
            for idx, (_, _, data) in enumerate(train_loader):
                timer.data_loaded()
                pts = torch.as_tensor(data[0] if isinstance(data, (tuple, list)) else data,
                                      dtype=torch.float32).to(dev)
                pending.append(pretrain_step(model, optimizer, schedule, pts, res.step,
                                             step_rngs(seed, res.step, dev), transform, clip,
                                             m))
                res.step += 1
                n_step += 1
                trace.step(n_step)
                if GUARD.check(n_step):
                    ckpt_lib.save_checkpoint(
                        model, optimizer, res.step, epoch, None,
                        res.best_metrics.state_dict(), "ckpt-last", experiment_path,
                        data_iter={"epoch": epoch, "next_batch": first + idx + 1},
                        loaders=named)
                    print_log(f"[PREEMPT] saved mid-epoch checkpoint at epoch {epoch} batch "
                              f"{first + idx + 1}; exiting gracefully", logger=logger)
                    res.preempted = True
                    return res  # the finally closes an open trace window
                timer.step_done()
                if idx % LOG_EVERY == 0:  # the losses fetched only here and at the epoch's end
                    for loss in pending[fetched:]:
                        meters.update([float(loss)])
                    fetched = len(pending)
                    lr = schedule(res.step)
                    print_log(f"[Epoch {epoch}][Batch {idx + 1}/{epoch_steps}] "
                              f"BatchTime={timer.batch_time.avg(0):.3f}s "
                              f"Loss={meters.avg(0):.4f} lr={lr:.6f}", logger=logger)
                    if train_writer is not None:
                        train_writer.add_scalar("Loss/Batch/Loss", float(pending[-1]), res.step)
                        train_writer.add_scalar("Loss/Batch/LR", lr, res.step)
                if max_steps and idx + 1 >= max_steps:
                    break
            for loss in pending[fetched:]:
                meters.update([float(loss)])
            res.epoch_loss.append(reduce_mean_scalar(meters.avg(0)))
            print_log(f"[Epoch {epoch}] EpochTime={time.time() - t0:.3f}s "
                      f"Loss={res.epoch_loss[-1]:.4f} steps={len(pending)} "
                      f"lr={schedule(res.step):.6f}", logger=logger)
            if probe and epoch % val_freq == 0:
                metric = validate(model, extra_loader, val_loader, val_npoints, epoch, logger)
                res.probes.append(metric)
                if metric.better_than(res.best_metrics):
                    res.best_metrics = metric
                    ckpt_lib.save_checkpoint(model, optimizer, res.step, epoch,
                                             metric.state_dict(), metric.state_dict(),
                                             "ckpt-best", experiment_path)
            ckpt_lib.save_checkpoint(model, optimizer, res.step, epoch, None,
                                     res.best_metrics.state_dict(), "ckpt-last",
                                     experiment_path)
            if is_snapshot_epoch(epoch):
                ckpt_lib.save_checkpoint(model, optimizer, res.step, epoch, None,
                                         res.best_metrics.state_dict(),
                                         f"ckpt-epoch-{epoch:03d}", experiment_path)
    finally:
        trace.close()
        train_loader.close()
        if probe:
            val_loader.close()
            extra_loader.close()
    return res


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
