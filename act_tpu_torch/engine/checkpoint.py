"""Checkpoints of the three trainers: save, resume, the start weights and the
pretrained-weights merge.

Counterpart of ``act_tpu/engine/checkpoint.py:68-115, 145-236, 361-405``
(``save_checkpoint``, ``resume_state``, ``load_params_into``,
``strip_student_prefix``, ``merge_pretrained``; reference
tools/builder.py:97-173, utils/checkpoint.py). A checkpoint is one ``torch.save`` file in the
reference layout ``{base_model, optimizer, epoch, metrics, best_metrics}``
(what ``engine/serve.py`` ``load_state_dict`` reads) plus the train step
``step``, named ``ckpt-last.pth``, ``ckpt-best.pth``, ``ckpt-best_vote.pth``,
``ckpt-epoch-NNN.pth`` in the experiment directory. Frozen weights stored in
bf16 are saved and restored in bf16. The save is synchronous and prints its
size and host seconds. Over several ranks only rank 0 writes, and every rank
waits for it (``parallel.barrier``). A preemption save carries a
``data_iter`` cursor ``{epoch, next_batch}``, and ``resume_state`` then
re-enters the interrupted epoch at that batch; it also carries the state of
the loaders' dataset draws (``DataLoader.rng_state``, one set a rank), which
the resume puts back on each rank, so a resumed run's items are those of an
uninterrupted one where batches are built in process (the JAX package
restarts them). A model sharded over tensor-parallel model groups
(``parallel/tp.py``) is saved and loaded in the full, one-process layout:
its shards and their optimizer moments are gathered before rank 0 writes,
and a load slices them back, as the JAX runners re-apply
``shard_params_tp`` on resume (``runner_finetune.py:163-168``); so a file
of a tensor-parallel run is the file of a one-process run.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from act_tpu_torch.parallel import (all_gather_objects, barrier, data_count, data_index,
                                    is_main_process)
from act_tpu_torch.parallel import tp

STUDENT_PREFIXES = ("ACT_encoder.", "base_model.")


def ckpt_path(experiment_path: str, prefix: str) -> str:
    return os.path.join(experiment_path, f"{prefix}.pth")


def save_checkpoint(model: nn.Module, optimizer: torch.optim.Optimizer, step: int,
                    epoch: int, metrics: Optional[Dict], best_metrics: Optional[Dict],
                    prefix: str, experiment_path: str,
                    data_iter: Optional[Dict[str, int]] = None,
                    loaders: Optional[Dict] = None) -> str:
    """Write ``{experiment_path}/{prefix}.pth`` on rank 0, then wait for it
    on every rank; returns its path. ``data_iter={'epoch': e, 'next_batch':
    k}`` marks a mid-epoch (preemption) save (``checkpoint.py:68-115``), with
    the draw states of the named ``loaders`` (one set a data index). Every
    rank calls it: a sharded model's tensors are gathered first."""
    path = ckpt_path(experiment_path, prefix)
    base, opt = tp.full_state_dict(model), tp.full_optimizer_state_dict(optimizer)
    draws = None
    if data_iter:  # every rank's draw states, gathered before rank 0 writes
        draws = all_gather_objects({k: s for k, s in ((k, ld.rng_state()) for k, ld in
                                                      (loaders or {}).items())
                                    if s is not None})
    if is_main_process():
        os.makedirs(experiment_path, exist_ok=True)
        t0 = time.perf_counter()
        payload = {"base_model": base, "optimizer": opt,
                   "step": int(step), "epoch": int(epoch), "metrics": dict(metrics or {}),
                   "best_metrics": dict(best_metrics or {})}
        if data_iter:
            payload["data_iter"] = {k: int(v) for k, v in data_iter.items()}
            payload["dataset_rng"] = draws
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        print(f"Saved checkpoint at {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
    barrier()
    return path


def resume_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                 experiment_path: str, loaders: Optional[Dict] = None
                 ) -> Tuple[int, int, Optional[Dict], int]:
    """Load ckpt-last into ``model`` (strict) and ``optimizer`` (reference
    resume_model, tools/builder.py:97-131; ``checkpoint.py:145-205``).
    Returns (start epoch, step, best metrics, start batch); (0, 0, None, 0)
    when there is no ckpt-last. A cursor (a preemption save) makes the
    start epoch the interrupted one and the start batch its ``next_batch``,
    and puts this data index's saved draw states back into the named
    ``loaders`` (when the run has as many data indices as the one saved); an
    epoch-end save starts the next epoch at batch 0. A sharded model and its
    optimizer take their shards of the full-layout file."""
    path = ckpt_path(experiment_path, "ckpt-last")
    if not os.path.exists(path):
        print(f"[RESUME] no checkpoint at {path}", flush=True)
        return 0, 0, None, 0
    dev = next(model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    tp.load_full_state_dict(model, payload["base_model"], strict=True)
    tp.load_full_optimizer_state_dict(optimizer, payload["optimizer"])
    start_batch = int((payload.get("data_iter") or {}).get("next_batch", 0))
    if start_batch > 0:
        start_epoch = int(payload["epoch"])
        draws = payload.get("dataset_rng") or []
        if len(draws) == data_count():
            for name, state in draws[data_index()].items():
                if loaders and name in loaders:
                    loaders[name].set_rng_state(state)
        print(f"[RESUME] resumed mid-epoch {start_epoch} at batch {start_batch} "
              "(preemption checkpoint)", flush=True)
    else:
        start_epoch = int(payload["epoch"]) + 1
        print(f"[RESUME] resumed at epoch {start_epoch}", flush=True)
    return start_epoch, int(payload["step"]), payload.get("best_metrics"), start_batch


def load_params_into(model: nn.Module, path: str) -> None:
    """``--start_ckpts``: the weights of the checkpoint at ``path`` into
    ``model``, strictly; the optimizer, step and epoch start fresh
    (``checkpoint.py:207-212``); a sharded model takes its shards."""
    payload = torch.load(path, map_location=next(model.parameters()).device,
                         weights_only=True)
    tp.load_full_state_dict(model, payload["base_model"], strict=True)
    print(f"[CKPT] loaded the weights of {path}", flush=True)


def strip_student_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Lift ``ACT_encoder.``/``base_model.`` keys to the top level (the
    reference's load_model_from_ckpt, models/act.py:841-848); a lifted key
    takes precedence over a top-level one of the same name
    (``checkpoint.py:216-236``)."""
    out = {k: v for k, v in sd.items() if not k.startswith(STUDENT_PREFIXES)}
    for k, v in sd.items():
        for p in STUDENT_PREFIXES:
            if k.startswith(p):
                out[k[len(p):]] = v
    return out


def merge_pretrained(model: nn.Module, loaded: Mapping[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Copy each tensor of ``loaded`` into ``model``'s state where name and
    shape match (``checkpoint.py:361-405``, a strict=False load). Returns
    (missing, unexpected), sorted: the model's keys absent from ``loaded``
    and the loaded keys absent from the model (a key in both with another
    shape is left as it was, as in the JAX package)."""
    state = model.state_dict()
    merged = {k: v for k, v in loaded.items()
              if k in state and tuple(v.shape) == tuple(state[k].shape)}
    with torch.no_grad():
        for k, v in merged.items():
            state[k].copy_(v)
    missing, unexpected = sorted(set(state) - set(loaded)), sorted(set(loaded) - set(state))
    print(f"[CKPT] merged {len(merged)} matching tensors; missing {len(missing)}, "
          f"unexpected {len(unexpected)}", flush=True)
    return missing, unexpected
