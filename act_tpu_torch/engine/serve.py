"""The serving forwards: a classifier built from its YAML, the part and
semantic segmentation models, and a pretrain model's features.

Counterpart of ``act_tpu/engine/export.py:36-71, 126-147, 189-247``. Where the
JAX package exports a jitted artifact, the port serves the eager module
directly: the classifier takes an FPS resample of the request cloud to
``npoints``, the segmentation models take clouds of exactly ``npoint``
points, and a pretrain model's features resample only clouds of another
point count.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping, Optional, Union

import torch

from act_tpu_torch import ops
from act_tpu_torch.engine.weights import seg_reference_keys
from act_tpu_torch.models import MODELS
from act_tpu_torch.models.segmentation import NUM_SHAPE_CATEGORIES
from act_tpu_torch.ops import furthest_point_sample, gather_coords, resolve_device
from act_tpu_torch.utils.config import ConfigDict, as_cfg, cfg_from_yaml_file

Checkpoint = Union[str, os.PathLike, Mapping]


def load_config(config) -> ConfigDict:
    """A YAML path or a mapping -> ConfigDict."""
    if isinstance(config, (str, os.PathLike)):
        return cfg_from_yaml_file(os.fspath(config))
    return as_cfg(config)


def load_state_dict(ckpt: Checkpoint) -> dict:
    """A reference ``.pth`` path or a state dict -> {key: tensor}.

    Takes the ``base_model`` (else ``state_dict``/``model_state_dict``/
    ``model``) entry when there is one and strips DDP's ``module.`` prefix,
    as ``act_tpu/engine/torch_convert.py:30-42`` does."""
    sd = ckpt
    if isinstance(ckpt, (str, os.PathLike)):
        sd = torch.load(os.fspath(ckpt), map_location="cpu", weights_only=True)
    for k in ("base_model", "state_dict", "model_state_dict", "model"):
        if isinstance(sd, Mapping) and k in sd:
            sd = sd[k]
            break
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_model(config, ckpt_path: Optional[Checkpoint] = None, seed: int = 0,
               device="cuda") -> torch.nn.Module:
    """Build ``config.model`` in eval mode on ``device``.

    With ``ckpt_path`` (a reference ``.pth`` path or a state dict) the weights
    load with ``strict=True``; otherwise they are drawn from ``seed``.
    ``device`` defaults to the card and raises when there is none."""
    cfg = load_config(config)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MODELS.build(cfg.model)
    model = model.to_empty(device="cpu")
    if ckpt_path is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(load_state_dict(ckpt_path), strict=True)
    return model.to(dev).eval()


def build_infer_fn(model: torch.nn.Module, npoints: int, with_fps: bool = True
                   ) -> Callable[..., torch.Tensor]:
    """The serving forward: (B, N_in, 3) points -> the model's f32 output on
    its device ((B, cls_dim) logits, or (B, npoints, C) log-probs of a
    segmentation model), under ``torch.inference_mode()``.

    ``with_fps`` prepends the reference eval protocol's FPS resample to
    ``npoints`` (runner_finetune.infer_step); with it off the input must
    already be (B, npoints, 3), as in the segmentation artifact
    (``export.py:241-247``). A part-segmentation model (``with_label``) also
    takes the (B, 16) object-category one-hot."""
    device = next(model.parameters()).device
    with_label = getattr(model, "with_label", False)

    def infer(pts, cls_label=None) -> torch.Tensor:
        pts = torch.as_tensor(pts, dtype=torch.float32).to(device).contiguous()
        if pts.dim() != 3 or pts.shape[-1] != 3:
            raise ValueError(f"points must be (B, N, 3), got {tuple(pts.shape)}")
        if not with_fps and pts.shape[1] != npoints:
            raise ValueError(f"without FPS the input must have npoints={npoints} "
                             f"points, got {pts.shape[1]}")
        inputs = (pts,)
        if with_label:
            lab = torch.as_tensor(cls_label, dtype=torch.float32).to(device)
            if tuple(lab.shape) != (pts.shape[0], NUM_SHAPE_CATEGORIES):
                raise ValueError(f"cls_label must be (B, {NUM_SHAPE_CATEGORIES}) one-hot, "
                                 f"got {tuple(lab.shape)}")
            inputs = (pts, lab)
        with torch.inference_mode():
            if with_fps:
                inputs = (gather_coords(pts, furthest_point_sample(pts, npoints)),) + inputs[1:]
            return model(*inputs)
    return infer


def build_features_fn(model: torch.nn.Module, npoints: int) -> Callable[..., torch.Tensor]:
    """A pretrain model's feature forward (``export_features``,
    ``export.py:126-147``, and the SVM probe's ``feat_step``): (B, N, 3)
    points, resampled by FPS + gather to ``npoints`` when N differs, -> its
    ``forward_eval`` cls features (B, cls_dim) on its device, under
    ``torch.inference_mode()``. The caller puts the model in eval mode."""
    device = next(model.parameters()).device

    def features(pts) -> torch.Tensor:
        pts = torch.as_tensor(pts, dtype=torch.float32).to(device).contiguous()
        if pts.dim() != 3 or pts.shape[-1] != 3:
            raise ValueError(f"points must be (B, N, 3), got {tuple(pts.shape)}")
        with torch.inference_mode():
            if pts.shape[1] != npoints:
                pts = ops.gather_coords(pts, ops.furthest_point_sample(pts, npoints))
            return model(pts, noaug=True)
    return features


SEG_TASKS = {"partseg": ("PartSegTransformer", 50), "semseg": ("SemSegTransformer", 13)}


def seg_config(task: str, num_group: int = 128, dtype: str = "bf16") -> ConfigDict:
    """The model config of a segmentation ``task`` ('partseg' or 'semseg') as
    the JAX runners and ``export_segmentation`` build it: 50 or 13 classes,
    ``num_group`` groups of 32 points, compute ``dtype``."""
    if task not in SEG_TASKS:
        raise ValueError(f"task must be partseg|semseg, got {task!r}")
    name, cls_dim = SEG_TASKS[task]
    return ConfigDict(dict(NAME=name, cls_dim=cls_dim, num_group=int(num_group),
                           group_size=32, dtype=dtype))


def load_seg_model(task: str, ckpt_path: Optional[Checkpoint] = None, num_group: int = 128,
                   dtype: str = "bf16", seed: int = 0, device="cuda") -> torch.nn.Module:
    """``load_model`` of the segmentation model of ``task``; a checkpoint may
    carry the reference's ``_cls`` head keys or the released ones."""
    ckpt = None if ckpt_path is None else seg_reference_keys(load_state_dict(ckpt_path))
    return load_model({"model": seg_config(task, num_group, dtype)}, ckpt, seed, device)
