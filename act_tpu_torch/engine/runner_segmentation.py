"""Segmentation runners: ShapeNetPart and S3DIS training and evaluation, and the
whole-scene vote.

Counterpart of ``act_tpu/engine/runner_segmentation.py`` (reference
part_segmentation/main.py, semantic_segmentation/main.py and main_test.py):
per-category part IoU with the absent-part = 1.0 rule and ckpt-best on the
instance mIoU; S3DIS with the class-weighted NLL, OA/mAcc/mIoU and ckpt-best
on the mIoU; the sliding-window whole-scene vote with the blocks batched.
A train step scales and shifts the batch on the host (``_np_augment``),
then ``engine/train_state.seg_step``: the train-mode forward, NLL, the clip
at 10 and AdamW (weight decay on every parameter, as optax's ``adamw``
without a mask) at the CosLR lr warming up over ``min(10, epoch)`` epochs.
Checkpoints are ``.pth`` files in the reference key layout
(``engine/checkpoint.py``); ``ckpts`` starts from a pretrained student
(prefixes lifted, merged by name and shape). Not ported: the TPU workarounds
(``--scan_steps``, the kernel mesh, TP sharding, ``--smoke``); ``max_steps``
caps an epoch's train batches and, with ``eval_batches``, its evaluation.

Over several ranks (``act_tpu_torch.parallel``, one process a card under
``torch.distributed.run``) a step is the one-process step on the global
batch, as the JAX runner's program over its mesh (``runner_segmentation.py:
162, 291``): ``batch_size`` is global and each rank loads its
``batch_size / R`` rows (``DataLoader(num_replicas=R, rank=r)``), the
augmentation is drawn for the global batch and each rank keeps its rows,
the start weights are rank 0's, the weighted S3DIS loss divides by the
global weight sum (``models/segmentation.nll_seg_loss``). The evaluation
runs each rank's share of the test split and gathers the per-cloud results
in the loader's index order without the padded repeats, so the metrics,
and with them the save decision, are one process's over the same clouds on
every rank; the epoch loss is the ranks' mean; only rank 0 logs and writes
ckpt-best. The whole-scene vote runs on one process, as JAX's does.

Every entry point runs on the card unless ``device="cpu"`` is given; the
data fall back to synthetic clouds when the data root is absent.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import islice
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.datasets.segmentation_datasets import (NUM_SHAPE_CATEGORIES,
                                                          S3DIS_NUM_CLASSES, SEG_CLASSES,
                                                          PartNormalDataset, S3DISDataset,
                                                          WholeSceneDataset)
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine.serve import build_infer_fn, load_seg_model, load_state_dict
from act_tpu_torch.engine.train_state import seg_step, step_rngs
from act_tpu_torch.ops import resolve_device
from act_tpu_torch.parallel import (broadcast_module, data_count, data_index,
                                    gather_in_index_order, model_count, process_count,
                                    reduce_mean_scalar, tp)
from act_tpu_torch.utils.config import ConfigDict
from act_tpu_torch.utils.logger import print_log

PARTSEG_ROOT = "data/shapenetcore_partanno_segmentation_benchmark_v0_normal"
S3DIS_ROOT = "data/stanford_indoor3d"
GRAD_NORM_CLIP = 10.0
CATEGORIES = sorted(SEG_CLASSES)  # category id -> name


def _np_augment(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """Random scale in [0.8, 1.25) and shift in [-0.1, 0.1) per cloud
    (provider.random_scale_point_cloud + shift_point_cloud,
    part_segmentation/main.py:197-199), drawn for the global batch: over R
    data indices of b clouds each, R*b of each, and data index r keeps rows
    [r*b, (r+1)*b)."""
    R, r, b = data_count(), data_index(), pts.shape[0]
    s = rng.uniform(0.8, 1.25, (R * b, 1, 1)).astype(np.float32)[r * b:(r + 1) * b]
    t = rng.uniform(-0.1, 0.1, (R * b, 1, 3)).astype(np.float32)[r * b:(r + 1) * b]
    return pts * s + t


def part_iou_per_shape(pred: np.ndarray, target: np.ndarray, cat: str) -> List[float]:
    """The IoU of each part of ``cat`` on one shape; a part absent from both
    prediction and target counts 1.0."""
    ious = []
    for part in SEG_CLASSES[cat]:
        gt, pr = target == part, pred == part
        union = np.sum(gt | pr)
        ious.append(float(np.sum(gt & pr) / union) if union else 1.0)
    return ious


def _numpy(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eval_batches(loader: Iterable, max_batches: Optional[int]) -> Iterable:
    return islice(loader, max_batches) if max_batches else loader


def evaluate_partseg(infer: Callable, loader: Iterable, logger=None,
                     max_batches: Optional[int] = None) -> Dict[str, float]:
    """Accuracy, class-average and instance-average mIoU over ``loader``'s
    (points, category ids, part labels) batches (the first ``max_batches``).
    ``infer(points, one_hot)`` gives (B, N, 50) log-probs; each shape's
    argmax is taken over its own category's parts
    (``runner_segmentation.py:68-98``). Over several ranks ``loader`` is a
    rank's share of the split and every rank returns the metrics of all of
    them (``gather_in_index_order``)."""
    cats, rows = [], []  # a shape's category, [its mean part IoU, points right, points]
    for pts, cls, seg in _eval_batches(loader, max_batches):
        cls = np.asarray(cls)
        one_hot = np.eye(NUM_SHAPE_CATEGORIES, dtype=np.float32)[cls]
        logits = _numpy(infer(np.asarray(pts)[..., :3], one_hot))
        seg = np.asarray(seg)
        for b, c in enumerate(cls):
            cat = CATEGORIES[c]
            parts = np.asarray(SEG_CLASSES[cat])
            pred = parts[logits[b][:, parts].argmax(-1)]
            cats.append(int(c))
            rows.append([float(np.mean(part_iou_per_shape(pred, seg[b], cat))),
                         float((pred == seg[b]).sum()), float(pred.size)])
    cats, rows = gather_in_index_order(loader, np.asarray(cats, dtype=np.int64),
                                       np.asarray(rows, dtype=np.float64).reshape(-1, 3))
    shape_ious = {cat: [] for cat in SEG_CLASSES}
    for c, row in zip(cats, rows):
        shape_ious[CATEGORIES[c]].append(float(row[0]))
    correct, seen = int(rows[:, 1].sum()), int(rows[:, 2].sum())
    all_ious = [i for v in shape_ious.values() for i in v]
    cat_ious = {c: float(np.mean(v)) for c, v in shape_ious.items() if v}
    metrics = {"accuracy": correct / max(seen, 1),
               "class_avg_iou": float(np.mean(list(cat_ious.values()))) if cat_ious else 0.0,
               "instance_avg_iou": float(np.mean(all_ious)) if all_ious else 0.0}
    for c, v in sorted(cat_ious.items()):
        print_log(f"  eval mIoU of {c:<14s} {v:.4f}", logger)
    print_log(f"[SEG EVAL] acc={metrics['accuracy']:.4f} cls-mIoU={metrics['class_avg_iou']:.4f} "
              f"ins-mIoU={metrics['instance_avg_iou']:.4f}", logger)
    return metrics


def _class_metrics(seen: np.ndarray, correct: np.ndarray, union: np.ndarray) -> Dict[str, float]:
    return {"OA": float(correct.sum() / max(seen.sum(), 1)),
            "mAcc": float(np.mean(correct / np.maximum(seen, 1))),
            "mIoU": float(np.mean(correct / np.maximum(union, 1)))}


def _class_counts(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> np.ndarray:
    """(3, num_classes): each class's points seen, predicted right, and in
    the union of prediction and label."""
    return np.stack([[np.sum(gt == c) for c in range(num_classes)],
                     [np.sum((pred == c) & (gt == c)) for c in range(num_classes)],
                     [np.sum((pred == c) | (gt == c)) for c in range(num_classes)]]
                    ).astype(np.float64)


def evaluate_semseg(infer: Callable, loader: Iterable, num_classes: int = S3DIS_NUM_CLASSES,
                    logger=None, max_batches: Optional[int] = None) -> Dict[str, float]:
    """OA, mAcc and mIoU over ``loader``'s (points, labels) batches (the first
    ``max_batches``); ``infer(points)`` gives (B, N, C) log-probs
    (``runner_segmentation.py:101-123``). The counts are taken a block and
    summed in the loader's index order (integers, exact in f64); over
    several ranks every rank's blocks are gathered first
    (``gather_in_index_order``)."""
    counts = []
    for pts, seg in _eval_batches(loader, max_batches):
        pred, gt = _numpy(infer(np.asarray(pts))).argmax(-1), np.asarray(seg)
        counts += [_class_counts(p, g, num_classes) for p, g in zip(pred, gt)]
    (counts,) = gather_in_index_order(
        loader, np.asarray(counts, dtype=np.float64).reshape(-1, 3, num_classes))
    metrics = _class_metrics(*counts.sum(0))
    print_log(f"[SEMSEG EVAL] OA={metrics['OA']:.4f} mAcc={metrics['mAcc']:.4f} "
              f"mIoU={metrics['mIoU']:.4f}", logger)
    return metrics


@dataclass
class SegState:
    """The model in training, its optimizer and the lr schedule (step -> lr)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]


def build_seg_state(task: str, steps_per_epoch: int, *, epoch: int = 300,
                    learning_rate: float = 2e-4, weight_decay: float = 5e-2,
                    num_group: int = 128, dtype: str = "bf16", ckpts=None, seed: int = 0,
                    device="cuda", widths: Optional[Dict] = None) -> SegState:
    """The ``task`` model with weights drawn from ``seed`` (then the
    pretrained tensors of ``ckpts`` where given), AdamW over every trainable
    parameter with decay ``weight_decay``, and the CosLR schedule over
    ``epoch`` epochs of ``steps_per_epoch`` steps
    (``runner_segmentation.py:126-134``), on ``device``. ``widths`` narrows
    the backbone (``serve.seg_config``). Under a tensor-parallel grid the
    model is sharded before AdamW is built (``runner_segmentation.py:186-190``)."""
    model = load_seg_model(task, None, num_group, dtype, seed, device="cpu", widths=widths)
    if ckpts is not None:
        ckpt_lib.merge_pretrained(model, ckpt_lib.strip_student_prefix(load_state_dict(ckpts)))
    model = tp.shard_module(model.to(resolve_device(device)))
    schedule = builder.build_schedule(ConfigDict(dict(
        scheduler=dict(type="CosLR", kwargs=dict(epochs=int(epoch),
                                                 initial_epochs=min(10, int(epoch)))),
        optimizer=dict(kwargs=dict(lr=float(learning_rate))))), steps_per_epoch)
    optimizer = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad],
                                  lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=float(weight_decay))
    return SegState(model, optimizer, schedule)


@dataclass
class SegResult:
    """What ``run_partseg`` and ``run_semseg`` return: the final state, the
    best metric (instance mIoU or mIoU), each epoch's mean loss and
    metrics, every step's loss, the steps taken."""
    state: SegState
    best: float
    epoch_loss: List[float] = field(default_factory=list)
    epoch_metrics: List[Dict[str, float]] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    steps: int = 0


def _loader(ds, batch_size: int, train: bool, seed: int, num_workers: int) -> DataLoader:
    """Train: shuffled by (seed, epoch), without the last partial batch. Real
    data may take forked workers; synthetic data is built in process. Over R
    data indices ``batch_size`` is global: each loads ``batch_size / R``
    samples a batch from its share of the index space (model peers load
    the same); raises unless R divides it."""
    R = process_count() // model_count()  # the data indices
    if int(batch_size) % R:
        raise ValueError(f"batch_size {batch_size} is global and must divide over {R} ranks")
    workers = 0 if getattr(ds, "synthetic", False) else int(num_workers)
    return DataLoader(ds, int(batch_size) // R, shuffle=train, drop_last=train, seed=seed,
                      prefetch=2 if workers else 0, num_workers=workers, num_replicas=R,
                      rank=data_index())


def _run(task: str, train_ds, test_ds, *, npoint: int, batch_size: int, epoch: int, learning_rate: float,
         weight_decay: float, num_group: int, dtype: str, ckpts, experiment_path: str,
         seed: int, device, max_steps: Optional[int], eval_batches: Optional[int],
         num_workers: int, logger) -> SegResult:
    """The epoch loop shared by both tasks (``runner_segmentation.py:137-273, 276-394``);
    every rank takes the same save decision from the gathered metrics."""
    dev = resolve_device(device)
    partseg = task == "partseg"
    train_loader = _loader(train_ds, batch_size, True, seed, num_workers)
    test_loader = _loader(test_ds, batch_size, False, seed, num_workers)
    weight = None if partseg else torch.as_tensor(train_ds.labelweights, dtype=torch.float32,
                                                  device=dev)
    key = "instance_avg_iou" if partseg else "mIoU"
    try:
        st = build_seg_state(task, max(len(train_loader), 1), epoch=epoch,
                             learning_rate=learning_rate, weight_decay=weight_decay,
                             num_group=num_group, dtype=dtype, ckpts=ckpts, seed=seed,
                             device=dev)
        broadcast_module(st.model)  # rank 0's start weights (seeded or from ckpts)
        infer = build_infer_fn(st.model, int(npoint), with_fps=False)
        res = SegResult(st, 0.0)
        np_rng = np.random.default_rng(0)
        for ep in range(int(epoch)):
            train_loader.set_epoch(ep)
            t0, pending = time.time(), []
            for idx, batch in enumerate(train_loader):
                pts = torch.from_numpy(_np_augment(np_rng, np.asarray(batch[0])[..., :3])).to(dev)
                seg = torch.as_tensor(batch[-1]).to(dev)
                one_hot = (torch.from_numpy(np.eye(NUM_SHAPE_CATEGORIES, dtype=np.float32)[
                    np.asarray(batch[1])]).to(dev) if partseg else None)
                pending.append(seg_step(st.model, st.optimizer, st.schedule, pts, seg, res.steps,
                                        step_rngs(seed, res.steps, dev), one_hot, weight,
                                        GRAD_NORM_CLIP))
                res.steps += 1
                if max_steps and idx + 1 >= max_steps:
                    break
            losses = [float(x) for x in pending]  # one host fetch an epoch
            res.losses += losses
            res.epoch_loss.append(reduce_mean_scalar(np.mean(losses)) if losses
                                  else float("nan"))
            print_log(f"[{'PartSeg' if partseg else 'SemSeg'}][Epoch {ep}] "
                      f"loss={res.epoch_loss[-1]:.4f} time={time.time() - t0:.1f}s", logger)
            st.model.eval()
            metrics = (evaluate_partseg(infer, test_loader, logger, eval_batches) if partseg
                       else evaluate_semseg(infer, test_loader, logger=logger,
                                            max_batches=eval_batches))
            res.epoch_metrics.append(metrics)
            if metrics[key] > res.best:
                res.best = metrics[key]
                ckpt_lib.save_checkpoint(st.model, st.optimizer, res.steps, ep, metrics,
                                         {key: res.best}, "ckpt-best", experiment_path)
    finally:
        train_loader.close()
        test_loader.close()
    print_log(f"[{'PartSeg' if partseg else 'SemSeg'}] best "
              f"{'instance mIoU' if partseg else 'mIoU'} = {res.best:.4f}", logger)
    return res


def run_partseg(*, root: str = PARTSEG_ROOT, npoint: int = 2048, batch_size: int = 16,
                epoch: int = 300, learning_rate: float = 2e-4, weight_decay: float = 5e-2,
                normal: bool = False, ckpts=None, num_group: int = 128, dtype: str = "bf16",
                experiment_path: str = "work_dirs/part_seg/act_partseg", seed: int = 0,
                device="cuda", max_steps: Optional[int] = None,
                eval_batches: Optional[int] = None, num_workers: int = 0,
                logger=None) -> SegResult:
    """Train and evaluate ShapeNetPart (``runner_segmentation.py:137-273``):
    the trainval split at ``batch_size``, an evaluation of the test split
    after each epoch, ckpt-best on the instance mIoU. ``normal`` reads the
    normals as well; the model groups on xyz alone."""
    train_ds = PartNormalDataset(root, npoint, split="trainval", normal_channel=normal)
    test_ds = PartNormalDataset(root, npoint, split="test", normal_channel=normal)
    return _run("partseg", train_ds, test_ds, npoint=npoint, batch_size=batch_size, epoch=epoch,
                learning_rate=learning_rate, weight_decay=weight_decay, num_group=num_group,
                dtype=dtype, ckpts=ckpts, experiment_path=experiment_path, seed=seed,
                device=device, max_steps=max_steps, eval_batches=eval_batches,
                num_workers=num_workers, logger=logger)


def run_semseg(*, root: str = S3DIS_ROOT, npoint: int = 2048, batch_size: int = 32,
               epoch: int = 60, learning_rate: float = 2e-4, weight_decay: float = 5e-2,
               test_area: int = 5, ckpts=None, num_group: int = 128, dtype: str = "bf16",
               experiment_path: str = "work_dirs/sem_seg/act_semseg", seed: int = 0,
               device="cuda", max_steps: Optional[int] = None,
               eval_batches: Optional[int] = None, num_workers: int = 0,
               logger=None) -> SegResult:
    """Train and evaluate S3DIS (``runner_segmentation.py:276-394``): blocks
    of the areas other than ``test_area`` with the NLL weighted by the train
    split's label weights, an evaluation on ``test_area`` after each epoch,
    ckpt-best on the mIoU."""
    train_ds = S3DISDataset("train", root, npoint, test_area=int(test_area))
    test_ds = S3DISDataset("test", root, npoint, test_area=int(test_area))
    return _run("semseg", train_ds, test_ds, npoint=npoint, batch_size=batch_size, epoch=epoch,
                learning_rate=learning_rate, weight_decay=weight_decay, num_group=num_group,
                dtype=dtype, ckpts=ckpts, experiment_path=experiment_path, seed=seed,
                device=device, max_steps=max_steps, eval_batches=eval_batches,
                num_workers=num_workers, logger=logger)


def batched_blocks(ds: WholeSceneDataset, scene: int, eval_bs: int):
    """A scene's blocks in chunks of ``eval_bs``: (stacked blocks (eval_bs,
    N, 3), point indices of each block, real blocks); the last chunk is
    padded with its final block (``runner_segmentation.py:432-447``)."""
    buf = []
    for block, _labels, sel in ds.blocks_for_scene(scene):
        buf.append((block, sel))
        if len(buf) == eval_bs:
            yield np.stack([b for b, _ in buf]), [s for _, s in buf], eval_bs
            buf = []
    if buf:
        n = len(buf)
        buf += [buf[-1]] * (eval_bs - n)
        yield np.stack([b for b, _ in buf]), [s for _, s in buf], n


def whole_scene_eval(model: Optional[nn.Module] = None, *, root: str = S3DIS_ROOT,
                     npoint: int = 2048, test_area: int = 5, ckpts=None, num_group: int = 128,
                     dtype: str = "bf16", eval_batch_size: int = 16, vote_num: int = 3,
                     seed: int = 0, device="cuda", max_scenes: Optional[int] = None,
                     logger=None
                     ) -> Tuple[Dict[str, float], List[np.ndarray]]:
    """The sliding-window vote over the rooms of ``test_area``
    (``runner_segmentation.py:397-477``, reference main_test.py:54-139):
    each scene's blocks in batches of ``eval_batch_size``, ``vote_num``
    rounds, each block's probabilities added to its points' votes
    (``np.add.at``). ``model`` (eval mode, on ``device``), else the semseg
    model of ``ckpts`` (else seeded). Returns (OA/mAcc/mIoU, each scene's
    (points, 13) votes). ``max_scenes`` keeps the first scenes. It runs on
    one process, as the JAX vote does on one device."""
    dev = resolve_device(device)
    if model is None:
        model = load_seg_model("semseg", ckpts, num_group, dtype, seed, dev)
    elif next(model.parameters()).device.type != dev.type:
        raise ValueError(f"the model is on {next(model.parameters()).device}, not {dev}")
    model.eval()
    ds = WholeSceneDataset(root, npoint, test_area=int(test_area))
    infer = build_infer_fn(model, npoint, with_fps=False)
    eval_bs = int(eval_batch_size or 16)
    stats = np.zeros((3, S3DIS_NUM_CLASSES))
    votes = []
    for scene in range(len(ds) if max_scenes is None else min(len(ds), int(max_scenes))):
        pool = np.zeros((len(ds.semantic_labels[scene]), S3DIS_NUM_CLASSES))
        for _ in range(vote_num):
            for stacked, sels, n_real in batched_blocks(ds, scene, eval_bs):
                probs = torch.exp(infer(stacked)).cpu().numpy()
                for i in range(n_real):
                    np.add.at(pool, sels[i], probs[i])
        votes.append(pool)
        stats += _class_counts(pool.argmax(-1), np.asarray(ds.semantic_labels[scene]),
                               S3DIS_NUM_CLASSES)
    metrics = _class_metrics(*stats)
    print_log(f"[WHOLE-SCENE] OA={metrics['OA']:.4f} mAcc={metrics['mAcc']:.4f} "
              f"mIoU={metrics['mIoU']:.4f}", logger)
    return metrics, votes
