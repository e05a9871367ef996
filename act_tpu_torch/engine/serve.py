"""The serving forward: build a classifier from its YAML and run it.

Counterpart of ``act_tpu/engine/export.py:36-71``. Where the JAX package
exports a jitted artifact, the port serves the eager module directly: FPS
resample of the request cloud to ``npoints``, then ``PointTransformer``.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping, Optional, Union

import torch

from act_tpu_torch.models import MODELS
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
                   ) -> Callable[[object], torch.Tensor]:
    """The serving forward: (B, N_in, 3) points -> (B, cls_dim) f32 logits on
    the model's device.

    ``with_fps`` prepends the reference eval protocol's FPS resample to
    ``npoints`` (runner_finetune.infer_step); with it off the input must
    already be (B, npoints, 3)."""
    device = next(model.parameters()).device

    def infer(pts) -> torch.Tensor:
        pts = torch.as_tensor(pts, dtype=torch.float32).to(device).contiguous()
        if pts.dim() != 3 or pts.shape[-1] != 3:
            raise ValueError(f"points must be (B, N, 3), got {tuple(pts.shape)}")
        if not with_fps and pts.shape[1] != npoints:
            raise ValueError(f"without FPS the input must have npoints={npoints} "
                             f"points, got {pts.shape[1]}")
        with torch.inference_mode():
            if with_fps:
                pts = gather_coords(pts, furthest_point_sample(pts, npoints))
            return model(pts)
    return infer
