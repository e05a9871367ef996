"""Self-contained serving artifacts of the port's eval forwards.

Counterpart of ``act_tpu/engine/export.py``. Each serving forward of
``engine/serve.py`` (the classifier's ``build_infer_fn``, a pretrain model's
``build_features_fn``, a Stage-I dVAE's ``build_tokenize_fn`` and
``build_recon_fn``, a segmentation model's ``build_infer_fn`` without the
resample) is traced by ``torch.export.export`` with the weights baked in,
the batch fixed or symbolic (``torch.export.Dim``), and saved with
``torch.export.save`` as a ``.pt2`` file beside a ``.json`` sidecar. The
artifact reloads with no model code, config or checkpoint
(:func:`load_exported`).

What the artifact holds depends on where it was exported. On the card the
FPS, k-smallest and gather kernels stay ``act_tpu_torch::*`` nodes (the ops
that ``act_tpu_torch/ops`` registers, with fake implementations that handle a
symbolic batch), so its loader imports ``act_tpu_torch.ops`` and nothing
else of the port. Exported with ``device="cpu"`` it holds the plain versions
and runs wherever torch runs. (The JAX package keeps its Pallas kernels only
for a concrete batch on a TPU, ``export.py:74-94``.)

The recon forward draws its soft-Gumbel uniforms from a generator seeded 0
on every call (``serve.recon_uniforms``); the artifact bakes that draw for
its batch, so a symbolic batch raises: the draw on the card depends on the
whole shape, not on a prefix of one stream.

Each ``export_*`` returns an :class:`Exported`, the program with the meta
that serving it needs (its kind, point counts and, for part segmentation,
the one-hot's width), so that an artifact saved with no further meta
serves.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

MAGIC = "act-tpu-torch-export-v1"
EXAMPLE_BATCH = 2  # traced with a symbolic batch; 0 and 1 would be specialised


class _Forward(torch.nn.Module):
    """A serving forward as a module, so that ``torch.export`` lifts the
    model's parameters and buffers into the artifact's state."""

    def __init__(self, model: torch.nn.Module, fn: Callable[..., torch.Tensor]):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def _export(model: torch.nn.Module, fn: Callable, shapes: Sequence[tuple],
            batch: Optional[int]) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``fn`` on f32 inputs of ``shapes`` (each
    without its batch dimension), on the model's device; ``batch=None``
    keeps the batch symbolic (one ``Dim`` named 'batch' for every input)."""
    device = next(model.parameters()).device
    b = EXAMPLE_BATCH if batch is None else int(batch)
    example = tuple(torch.zeros((b, *s), dtype=torch.float32, device=device) for s in shapes)
    dynamic = None
    if batch is None:
        dim = torch.export.Dim("batch", min=1)
        dynamic = (tuple({0: dim} for _ in shapes),)  # forward(*inputs)
    return torch.export.export(_Forward(model, fn), example, dynamic_shapes=dynamic)


class Exported(NamedTuple):
    """An exported serving forward: the program and what serving it needs
    besides its shapes (``kind``, ``npoints``, ``n_in``, ``with_fps``, the
    compute ``dtype``, ``num_categories`` for part segmentation, and the
    ``config`` and ``ckpts`` paths it came from), which
    :func:`save_exported` writes into the sidecar."""
    program: torch.export.ExportedProgram
    meta: dict


def _path(x) -> Optional[str]:
    """A config or checkpoint argument as the sidecar names it: a path, or
    None for a mapping."""
    return os.fspath(x) if isinstance(x, (str, os.PathLike)) else None


def _meta(kind: str, config, ckpt_path, npoints: int, n_in: int, with_fps: bool,
          dtype, **extra) -> dict:
    return {"kind": kind, "config": _path(config), "ckpts": _path(ckpt_path),
            "npoints": int(npoints), "n_in": int(n_in), "with_fps": bool(with_fps),
            "dtype": dtype or "f32", **extra}


def export_classifier(config, ckpt_path=None, batch: Optional[int] = None,
                      n_in: Optional[int] = None, with_fps: bool = True, seed: int = 0,
                      device="cuda") -> Exported:
    """The classifier of ``config``: (B, n_in, 3) points -> (B, cls_dim)
    logits, the FPS resample to ``npoints`` first unless ``with_fps`` is off
    (then ``n_in`` must be ``npoints``)."""
    from act_tpu_torch.engine.serve import build_infer_fn, load_config, load_model

    cfg = load_config(config)
    npoints = int(cfg.npoints)
    n = int(n_in or npoints)
    if not with_fps and n != npoints:
        raise ValueError(f"without FPS n_in must be npoints ({npoints}), got {n}")
    model = load_model(cfg, ckpt_path, seed=seed, device=device)
    return Exported(_export(model, build_infer_fn(model, npoints, with_fps), [(n, 3)], batch),
                    _meta("classifier", config, ckpt_path, npoints, n, with_fps,
                          cfg.model.get("dtype")))


def export_features(config, ckpt_path=None, batch: Optional[int] = None,
                    n_in: Optional[int] = None, seed: int = 0, device="cuda") -> Exported:
    """A pretrain model's features (the SVM probe's forward): (B, n_in, 3)
    -> (B, cls_dim), resampled by FPS when ``n_in`` is not the config's
    ``npoints`` (else its val split's)."""
    from act_tpu_torch.engine.runner_pretrain import build_pretrain_model
    from act_tpu_torch.engine.serve import build_features_fn, features_npoints, load_config
    from act_tpu_torch.ops import resolve_device

    cfg = load_config(config)
    npoints = features_npoints(cfg)
    n = int(n_in or npoints)
    model = build_pretrain_model(cfg.model, seed, ckpt_path).to(resolve_device(device)).eval()
    return Exported(_export(model, build_features_fn(model, npoints), [(n, 3)], batch),
                    _meta("features", config, ckpt_path, npoints, n, n != npoints,
                          cfg.model.get("dtype")))


def _export_dvae(kind: str, config, ckpt_path, batch: Optional[int], seed: int,
                 device) -> Exported:
    from act_tpu_torch.engine.serve import (build_recon_fn, build_tokenize_fn, load_config,
                                            load_model, recon_uniforms)

    cfg = load_config(config)
    model = load_model(cfg, ckpt_path, seed=seed, device=device)
    npoints = int(cfg.npoints)
    if kind == "tokenize":
        fn = build_tokenize_fn(model, npoints)
    else:
        fn = build_recon_fn(model, npoints, gumbel_u=recon_uniforms(
            model, int(batch), next(model.parameters()).device))
    return Exported(_export(model, fn, [(npoints, 3)], batch),
                    _meta(kind, config, ckpt_path, npoints, npoints, False,
                          cfg.model.get("dtype")))


def export_dvae_tokenize(config, ckpt_path=None, batch: Optional[int] = None, seed: int = 0,
                         device="cuda") -> Exported:
    """A Stage-I dVAE's tokenizer: (B, npoints, 3) -> (B, G) int32 ids."""
    return _export_dvae("tokenize", config, ckpt_path, batch, seed, device)


def export_dvae_recon(config, ckpt_path=None, batch: Optional[int] = None, seed: int = 0,
                      device="cuda") -> Exported:
    """A Stage-I dVAE's reconstruction: (B, npoints, 3) -> (B, G*M, 3), with
    the draw of ``serve.recon_forward`` at ``batch`` clouds baked in. A
    symbolic batch raises ValueError."""
    if batch is None:
        raise ValueError(
            "the dvae (recon) kind needs a fixed --batch: its soft-Gumbel uniforms come from a "
            "generator seeded 0 at the request's (B, G, num_tokens) shape, and on the card that "
            "draw is not a prefix of one stream, so no draw depends on the batch alone")
    return _export_dvae("dvae", config, ckpt_path, batch, seed, device)


def export_segmentation(task: str, npoint: int = 2048, ckpt_path=None,
                        batch: Optional[int] = None, num_group: int = 128,
                        dtype: str = "bf16", seed: int = 0, device="cuda",
                        widths: Optional[Mapping] = None) -> Exported:
    """A segmentation model's per-point log-probs: (B, npoint, 3) [and the
    (B, 16) object-category one-hot for 'partseg'] -> (B, npoint, cls_dim).
    ``widths`` narrows the backbone (``serve.seg_config``)."""
    from act_tpu_torch.engine.serve import build_infer_fn, load_seg_model
    from act_tpu_torch.models.segmentation import NUM_SHAPE_CATEGORIES

    model = load_seg_model(task, ckpt_path, num_group=num_group, dtype=dtype, seed=seed,
                           device=device, widths=widths)
    n = int(npoint)
    extra = {"seg_task": task}
    shapes = [(n, 3)]
    if model.with_label:  # the handler then requires a cls_label
        extra["num_categories"] = NUM_SHAPE_CATEGORIES
        shapes.append((NUM_SHAPE_CATEGORIES,))
    return Exported(_export(model, build_infer_fn(model, n, with_fps=False), shapes, batch),
                    _meta("segmentation", None, ckpt_path, n, n, False, dtype, **extra))


def _shape(node) -> list:
    """A traced value's shape, the symbolic batch (the only symbolic
    dimension :func:`_export` makes) by its name."""
    return ["batch" if isinstance(d, torch.SymInt) else int(d) for d in node.meta["val"].shape]


def uses_kernel_ops(ep: torch.export.ExportedProgram) -> bool:
    """Whether the graph calls an ``act_tpu_torch::*`` op (a kernel of the
    card), so that its loader must import ``act_tpu_torch.ops``."""
    return any(n.op == "call_function" and str(n.target).startswith("act_tpu_torch.")
               for n in ep.graph.nodes)


def save_exported(exported: Exported, dst: str, meta: Optional[dict] = None) -> dict:
    """Write the artifact ``dst`` (``.pt2``) and its sidecar ``dst + '.json'``:
    the magic, the size, the input and output shapes (a symbolic batch by
    its name), dtypes and device, whether the kernel ops are needed, the
    export's own meta (kind, npoints, n_in, with_fps, ...) and ``meta``.
    Returns the sidecar."""
    ep = exported.program
    torch.export.save(ep, dst)
    names = set(ep.graph_signature.user_inputs)
    inputs = [n for n in ep.graph.nodes if n.op == "placeholder" and n.name in names]
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0][0]
    side = {"magic": MAGIC, "bytes": os.path.getsize(dst),
            "in_shapes": [_shape(n) for n in inputs],
            "out_shape": _shape(out),
            "in_dtype": "float32", "out_dtype": str(out.meta["val"].dtype).replace("torch.", ""),
            "device": inputs[0].meta["val"].device.type,
            "needs_ops": uses_kernel_ops(ep), **exported.meta, **(meta or {})}
    with open(dst + ".json", "w") as f:
        json.dump(side, f, indent=1)
    return side


def load_exported(src: str, device="cuda") -> Callable[..., torch.Tensor]:
    """An artifact and its sidecar -> a callable ``(points, *extra)`` ->
    the output tensor on the artifact's device (logits, features, token
    ids, reconstruction or log-probs by its kind), under
    ``torch.inference_mode()``. Imports ``act_tpu_torch.ops`` (the kernels'
    ops) and no model code. ``device`` must be the device the artifact was
    exported on (the card by default); inputs of another shape than the
    sidecar's raise ValueError. The callable carries ``meta`` (the sidecar)
    and ``exported`` (the program)."""
    from act_tpu_torch.ops import resolve_device  # registers the kernels' ops

    with open(src + ".json") as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{src}.json is not an {MAGIC} sidecar")
    dev = resolve_device(device)
    if dev.type != meta["device"]:
        raise ValueError(f"{src} was exported on {meta['device']}; serve it there "
                         f"(device={meta['device']!r}), not on {dev.type}")
    ep = torch.export.load(src)
    module = ep.module()
    shapes = meta["in_shapes"]

    def call(pts, *extra) -> torch.Tensor:
        if len(extra) != len(shapes) - 1:
            raise ValueError(f"the artifact takes {len(shapes)} inputs, got {1 + len(extra)}")
        args = []
        for x, want in zip((pts, *extra), shapes):
            x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                                dtype=torch.float32).to(dev).contiguous()
            if x.dim() != len(want) or any(isinstance(w, int) and w != d
                                           for w, d in zip(want, x.shape)):
                raise ValueError(f"the artifact takes inputs of shape {want}, "
                                 f"got {tuple(x.shape)}")
            args.append(x)
        with torch.inference_mode():
            return module(*args)

    call.meta = meta
    call.exported = ep
    return call
