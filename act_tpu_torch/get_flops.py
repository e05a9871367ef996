"""FLOPs and parameters of a config's model (counterpart of ``tools/get_flops.py``).

  python -m act_tpu_torch.get_flops \
      --config cfgs/finetune_classification/full/finetune_modelnet.yaml
  python -m act_tpu_torch.get_flops --config <yaml> [--npoints 1024] [--device cuda|cpu]

Builds ``MODELS.build(config.model)`` with weights drawn from a seed and runs
one forward of a (1, npoints, 3) cloud drawn from a seed, with every random
stream given, in the mode the JAX model's ``__call__`` takes by default: eval,
but the Stage-II pretrain models in training mode, their BatchNorm
statistics updated (the JAX tool applies those without ``mutable`` and
raises; ROADMAP.md section 3, fault (e)). Params is the count of
``model.parameters()`` less the conv biases that the JAX package folds into
the BatchNorm means (``FOLDED_BIASES`` of the group encoder and the FoldingNet
decoder: zero, never trained, kept for the reference's key layout), so that
it equals the count of the JAX model's ``params``. FLOPs are ``torch.utils.flop_counter``'s count (a
product's multiply and add are two) plus each kernel's formula
(``ops/work.py``): ``FlopCounterMode`` counts the kernels of the registered
ops (FPS, k-smallest, the gather) on the card, and the wrappers record the
same formulas on the plain path and for the Gumbel and Chamfer kernels, so a
count does not depend on the device. The run is on the card unless
``--device cpu`` is given. Prints the JAX tool's four lines.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from act_tpu_torch.engine.serve import load_config
from act_tpu_torch.engine.train_state import step_rngs
from act_tpu_torch.models import MODELS
from act_tpu_torch.ops import resolve_device, work

# models whose JAX ``__call__`` defaults to ``train=True``
TRAIN_MODE = ("ACT_PointDistillation", "ACT_PointBERT")
KERNEL_OP = "act_tpu_torch."  # the registered ops' namespace in FlopCounterMode's counts


class FlopCount(NamedTuple):
    model: str
    npoints: int
    params: int
    flops: int
    aten_flops: int  # FlopCounterMode's count of the aten ops
    kernel_flops: Dict[str, int]  # kernel -> its formula's count, for each kernel that ran


def model_config(cfg):
    """``cfg.model``, or a ValueError for a YAML that names no model the tool
    can build (as the JAX tool fails on them): a t-SNE YAML (two models, no
    ``model``) and a few-shot YAML (``cls_dim`` -1 until ``--way`` sets it)."""
    if "model" not in cfg:
        raise ValueError(f"the config has no 'model' node (it has {sorted(cfg)}): a t-SNE "
                         "config's two models are counted from finetune configs of their own")
    if int(cfg.model.get("cls_dim", 0)) < 0:
        raise ValueError(f"model.cls_dim is {cfg.model.cls_dim}: a few-shot config takes its "
                         "classes from --way; count the finetune config of the same model")
    return cfg.model


def params(model: torch.nn.Module) -> int:
    """The model's parameters less the folded conv biases."""
    folded = sum(m.get_parameter(n).numel() for m in model.modules()
                 for n in getattr(m, "FOLDED_BIASES", ()))
    return sum(p.numel() for p in model.parameters()) - folded


def build(config, seed: int = 0, device="cuda") -> torch.nn.Module:
    """``config``'s model with weights drawn from ``seed`` by a generator on
    ``device`` (a count depends on shapes alone; on the card the draw takes
    milliseconds, on the CPU seconds), in the mode the JAX model's
    ``__call__`` defaults to, without gradients (a forward is counted, no
    graph)."""
    cfg = load_config(config)
    model_cfg = model_config(cfg)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MODELS.build(model_cfg)
    model = model.to_empty(device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.train(model_cfg.NAME in TRAIN_MODE).requires_grad_(False)


def count(model: torch.nn.Module, npoints: int = 1024, seed: int = 0) -> FlopCount:
    """One forward of ``model`` (``build``) on a (1, npoints, 3) cloud from
    ``seed``, on the model's device, counted."""
    dev = next(model.parameters()).device
    pts = torch.randn(1, npoints, 3, generator=torch.Generator().manual_seed(seed)).to(dev)
    with work.Work() as w, FlopCounterMode(display=False) as fc:
        model(pts, rngs=step_rngs(seed, 0, dev))
    kernels, aten = dict(w.flops), 0
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        name = str(op)
        if name.startswith(KERNEL_OP):
            k = name[len(KERNEL_OP):]
            kernels[k] = kernels.get(k, 0) + n
        else:
            aten += n
    return FlopCount(type(model).__name__, npoints, params(model),
                     aten + sum(kernels.values()), aten, kernels)


def report(c: FlopCount) -> List[str]:
    """The JAX tool's four lines."""
    mode = "training mode" if c.model in TRAIN_MODE else "eval"
    return [f"Model:  {c.model}",
            f"Input:  (1, {c.npoints}, 3)",
            f"Params: {c.params / 1e6:.2f} M",
            f"FLOPs:  {c.flops / 1e9:.2f} GFLOPs (torch FlopCounterMode and the kernels' "
            f"formulas, fwd, {mode})"]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--npoints", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    model = build(args.config, device=args.device)
    print("\n".join(report(count(model, args.npoints))), flush=True)


if __name__ == "__main__":
    main()
