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
size and host seconds.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

STUDENT_PREFIXES = ("ACT_encoder.", "base_model.")


def ckpt_path(experiment_path: str, prefix: str) -> str:
    return os.path.join(experiment_path, f"{prefix}.pth")


def save_checkpoint(model: nn.Module, optimizer: torch.optim.Optimizer, step: int,
                    epoch: int, metrics: Optional[Dict], best_metrics: Optional[Dict],
                    prefix: str, experiment_path: str) -> str:
    """Write ``{experiment_path}/{prefix}.pth``; returns its path."""
    os.makedirs(experiment_path, exist_ok=True)
    path = ckpt_path(experiment_path, prefix)
    t0 = time.perf_counter()
    torch.save({"base_model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch), "metrics": dict(metrics or {}),
                "best_metrics": dict(best_metrics or {})}, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(f"Saved checkpoint at {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    return path


def resume_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                 experiment_path: str) -> Tuple[int, int, Optional[Dict]]:
    """Load ckpt-last into ``model`` (strict) and ``optimizer`` (reference
    resume_model, tools/builder.py:97-131). Returns (start epoch, step,
    best metrics); (0, 0, None) when there is no ckpt-last."""
    path = ckpt_path(experiment_path, "ckpt-last")
    if not os.path.exists(path):
        print(f"[RESUME] no checkpoint at {path}", flush=True)
        return 0, 0, None
    dev = next(model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(payload["base_model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    start_epoch = int(payload["epoch"]) + 1
    print(f"[RESUME] resumed at epoch {start_epoch}", flush=True)
    return start_epoch, int(payload["step"]), payload.get("best_metrics")


def load_params_into(model: nn.Module, path: str) -> None:
    """``--start_ckpts``: the weights of the checkpoint at ``path`` into
    ``model``, strictly; the optimizer, step and epoch start fresh
    (``checkpoint.py:207-212``)."""
    payload = torch.load(path, map_location=next(model.parameters()).device,
                         weights_only=True)
    model.load_state_dict(payload["base_model"], strict=True)
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
