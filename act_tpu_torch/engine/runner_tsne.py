"""The t-SNE runner: pretrained against finetuned features of the test set.

Counterpart of ``act_tpu/engine/runner_tsne.py`` (reference
tools/runner_tsne.py). ``tsne_net`` builds a pretrained and a finetuned
``PointTransformer`` (``config.model_pretrained`` / ``config.model_finetuned``,
their checkpoints ``config.ckpt_pretrained`` / ``config.ckpt_finetuned``, or
``--ckpts`` for the finetuned one), resamples each test batch by FPS to
``npoints``, takes both models' ``[cls | maxpool]`` features
(``extract_feature``) and the finetuned logits, reports OA and mAcc, embeds
the correctly classified clouds' features of each model with the port's
t-SNE (``utils/tsne.py``, in place of scikit-learn's) and runs the
300-round 10-vote test of the finetuned model
(``runner_finetune.test_vote_rounds``; 2 rounds under ``max_batches``). A
config with only ``model`` embeds that model's features.

There is no plot (matplotlib is not a dependency of the port): each
embedding goes to an ``.npz`` file (``embedding`` (n, 2) f32, ``labels``
(n,)) in ``args.experiment_path``, ``tsne_pretrained.npz`` and
``tsne_finetuned.npz`` (``tsne.npz`` for one model), in place of the JAX
runner's ``.png``.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from act_tpu_torch import ops
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine.runner_finetune import _to_device, test_vote_rounds
from act_tpu_torch.engine.serve import load_model, load_state_dict
from act_tpu_torch.utils import tsne
from act_tpu_torch.utils.logger import print_log
from act_tpu_torch.utils.meters import balanced_accuracy

MIN_CORRECT = 8  # the fewest correctly classified clouds that are embedded
VOTE_ROUNDS = 300


def extract_features(model: torch.nn.Module, loader: Iterable, npoints: int,
                     with_logits: bool = False):
    """Each batch of ``loader`` resampled by FPS + gather to ``npoints``
    (the walk launches even when the clouds already have ``npoints``
    points), then ``model.extract_feature`` and, ``with_logits``, the eval
    logits of the same resampled clouds, on the model's device. Returns
    numpy (features (n, 2C) f32[, logits (n, cls_dim) f32], labels (n,))."""
    dev = next(model.parameters()).device
    model.eval()
    feats, logits, labels = [], [], []
    with torch.inference_mode():
        for batch in loader:
            pts, label = _to_device(batch, dev)
            pts = ops.gather_coords(pts, ops.furthest_point_sample(pts.contiguous(), npoints))
            feats.append(model.extract_feature(pts).float().cpu().numpy())
            if with_logits:
                logits.append(model(pts).float().cpu().numpy())
            labels.append(label.cpu().numpy())
    feats, labels = np.concatenate(feats), np.concatenate(labels)
    if with_logits:
        return feats, np.concatenate(logits), labels
    return feats, labels


def _build_and_load(model_cfg, ckpt_path, npoints: int, seed: int, device="cuda",
                    logger=None) -> torch.nn.Module:
    """``model_cfg`` in eval mode on ``device`` (``serve.load_model``,
    weights from ``seed``), with the tensors of ``ckpt_path`` (a ``.pth``;
    student prefixes lifted, merged by name and shape, as the finetune
    runner merges a pretrained checkpoint) where given. ``npoints`` is the
    JAX runner's init shape; the port builds without a sample."""
    del npoints
    if ckpt_path and (os.path.isdir(ckpt_path) or not str(ckpt_path).endswith(".pth")):
        raise ValueError(f"checkpoint '{ckpt_path}': the port reads a .pth checkpoint, not an "
                         "orbax directory")
    model = load_model({"model": model_cfg}, None, seed=seed or 0, device=device)
    if ckpt_path:
        ckpt_lib.merge_pretrained(model, ckpt_lib.strip_student_prefix(load_state_dict(ckpt_path)))
        print_log(f"[TSNE] loaded ckpt {ckpt_path}", logger)
    return model.eval()


def _save(emb: tsne.Embedding, labels: np.ndarray, path: str, logger) -> None:
    np.savez(path, embedding=emb.y, labels=labels, kl=emb.kl, n_iter=emb.n_iter,
             perplexity=emb.perplexity)
    print_log(f"[TSNE] saved {path} (KL {emb.kl:.6f} after {emb.n_iter + 1} iterations)",
              logger)


def _take(loader: Iterable, max_batches: Optional[int]):
    if max_batches is None:
        return loader
    batches = []
    for batch in loader:
        if len(batches) == max_batches:
            break
        batches.append(batch)
    return batches


def tsne_net(args, config, max_batches: Optional[int] = None
             ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The t-SNE protocol (``runner_tsne.py:88-169``) on ``args.device``
    (the card unless "cpu"): ``args`` carries ``experiment_path``,
    ``seed``, ``ckpts``, ``device`` and the logger's ``log_name``.
    Returns the two embeddings (None when fewer than ``MIN_CORRECT``
    clouds are classified correctly); one model's embedding and labels
    when the config has no pretrained/finetuned pair. ``max_batches``
    keeps the first test batches and runs 2 vote rounds."""
    logger = getattr(args, "log_name", None)
    device = getattr(args, "device", "cuda")
    seed = getattr(args, "seed", 0) or 0
    npoints = int(config.npoints)
    config.dataset.test.others.bs = config.total_bs
    config.dataset.test.others.FPS_DEVICE = str(device)  # where a ModelNet cache is built
    _, test_loader = builder.dataset_builder(config.dataset.test, seed)
    try:
        loader = _take(test_loader, max_batches)
        if not ("model_pretrained" in config and "model_finetuned" in config):
            model = _build_and_load(config.model, getattr(args, "ckpts", None), npoints,
                                    seed, device, logger)
            feats, labels = extract_features(model, loader, npoints)
            print_log(f"[TSNE] extracted {feats.shape} features", logger)
            emb = tsne.embed(feats, device)
            _save(emb, labels, os.path.join(args.experiment_path, "tsne.npz"), logger)
            return emb.y, labels

        ckpt_p = config.get("ckpt_pretrained", None)
        ckpt_f = config.get("ckpt_finetuned", None) or getattr(args, "ckpts", None)
        model_p = _build_and_load(config.model_pretrained, ckpt_p, npoints, seed, device,
                                  logger)
        model_f = _build_and_load(config.model_finetuned, ckpt_f, npoints, seed, device,
                                  logger)
        feats_p, labels = extract_features(model_p, loader, npoints)
        feats_f, logits_f, _ = extract_features(model_f, loader, npoints, with_logits=True)
        preds = logits_f.argmax(-1)
        correct = preds == labels
        oa = float(correct.mean()) * 100.0
        macc = balanced_accuracy(labels, preds) * 100.0
        print_log(f"[TEST] OA={oa:.4f}  mAcc={macc:.4f}", logger)

        embs = {"pretrained": None, "finetuned": None}
        if correct.sum() >= MIN_CORRECT:
            for name, feats in (("pretrained", feats_p), ("finetuned", feats_f)):
                emb = tsne.embed(feats[correct], device)
                _save(emb, labels[correct],
                      os.path.join(args.experiment_path, f"tsne_{name}.npz"), logger)
                embs[name] = emb.y
        else:
            print_log("[TSNE] too few correct predictions to embed", logger)

        rounds = 2 if max_batches is not None else VOTE_ROUNDS
        best = 0.0
        for r, acc in enumerate(test_vote_rounds(model_f, loader, npoints, seed, rounds,
                                                 device=device, logger=logger)):
            best = max(best, float(acc))
            print_log(f"[TEST_VOTE_time {r}]  OA={acc:.4f}, best OA={best:.4f}", logger)
        print_log(f"[TEST_VOTE] OA={best:.4f}", logger)
        return embs["pretrained"], embs["finetuned"]
    finally:
        test_loader.close()
