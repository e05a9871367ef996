"""Dense-prediction models: ShapeNetPart part segmentation and S3DIS semantic
segmentation.

Counterpart of ``act_tpu/models/segmentation.py`` (reference
part_segmentation/models/pt.py:178-355, semantic_segmentation/models/pt.py:
150-300): the student backbone with the hidden states of blocks {3, 7, 11}
fetched and each normed by one shared LayerNorm, global max and mean pooling
(and for part segmentation the 16-way object label through ``label_conv``),
3-NN inverse-distance feature propagation back to all N points
(``FeaturePropagation``), and a conv-BN-ReLU-dropout head with f32 log-softmax
outputs. The parameters keep the reference's keys without its ``_cls``
suffixes (``encoder.*``, ``pos_embed.*``, ``blocks.blocks.N.*``, ``norm.*``,
``propagation_0.mlp_convs.i``/``mlp_bns.i``, ``convs1-3``, ``bns1-2``,
``label_conv.0/1``); ``engine/weights.py`` carries JAX parameters and the
suffixed reference layout over.

Under the bf16 policy the LayerNorm outputs, the pooled features and the
interpolated features are f32, the convolutions and BatchNorms emit bf16,
and ``convs3`` and the log-softmax run in f32, cast for cast as in JAX.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (BatchNorm, Conv1x1, Dropout, GroupEncoder,
                                         LayerNorm, LeakyReLU, PosEmbedMLP, Rngs,
                                         TransformerEncoder, dense, dtype_from_cfg,
                                         init_weights)
from act_tpu_torch.parallel import all_reduce_sum, data_count
from act_tpu_torch.utils.config import as_cfg

NUM_SHAPE_CATEGORIES = 16


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling and a pointwise conv-BN-ReLU MLP
    (``segmentation.py:27-53``): unknown_xyz (B, N, 3), known_xyz (B, S, 3),
    unknown_feats (B, N, D1) or None, known_feats (B, S, D2) ->
    (B, N, mlp[-1]) in the compute dtype."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for out in mlp:
            self.mlp_convs.append(Conv1x1(last, out, dtype))
            self.mlp_bns.append(BatchNorm(out, dtype))
            last = out

    def forward(self, unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor
                ) -> torch.Tensor:
        new = ops.three_nn_interpolate(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            new = torch.cat([unknown_feats.to(new.dtype), new], dim=-1)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new = F.relu(bn(conv(new)))
        return new


class SegBackbone(nn.Module):
    """Group -> encoder -> 12 blocks with the hidden states of blocks
    ``fetch_idx`` each normed by ``norm`` and concatenated, no cls token
    (``segmentation.py:56-86``)."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 drop_path_rate: float = 0.1, encoder_dims: int = 384, group_size: int = 32,
                 num_group: int = 128, fetch_idx: Tuple[int, ...] = (3, 7, 11),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.fetch_idx = tuple(fetch_idx)
        self.compute_dtype = dtype
        self.encoder = GroupEncoder(encoder_dims, dtype=dtype)
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = TransformerEncoder(trans_dim, depth, num_heads, dtype=dtype,
                                         drop_path_rate=drop_path_rate)
        self.norm = LayerNorm(trans_dim, eps=1e-5)

    def backbone(self, pts: torch.Tensor, rngs: Rngs = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) -> (features (B, G, len(fetch_idx) * dim) f32, centers (B, G, 3))."""
        neighborhood, center = ops.group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(neighborhood)
        pos = self.pos_embed(center)
        _, feats = self.blocks(tokens, pos, rngs=rngs, return_hidden=self.fetch_idx)
        return torch.cat([self.norm(f) for f in feats], dim=-1), center


class _SegHead(SegBackbone):
    """The backbone and the shared scoring head (``segmentation.py:89-139``):
    propagate to all N points, ``convs1`` over [f_level_0 | globals], the
    conv stack, f32 log-softmax."""

    def __init__(self, cls_dim: int, with_label: bool, num_group: int = 128,
                 group_size: int = 32, dtype: Optional[torch.dtype] = None, **backbone):
        super().__init__(num_group=num_group, group_size=group_size, dtype=dtype, **backbone)
        C = self.trans_dim
        feat = C * len(self.fetch_idx)
        self.cls_dim, self.with_label = cls_dim, with_label
        if with_label:
            self.label_conv = nn.Sequential(
                Conv1x1(NUM_SHAPE_CATEGORIES, 64, dtype, bias=False), BatchNorm(64, dtype),
                LeakyReLU(0.2))
        self.propagation_0 = FeaturePropagation(feat + 3, [C * 4, 1024], dtype)
        self.convs1 = Conv1x1(1024 + 2 * feat + (64 if with_label else 0), 512, dtype)
        self.bns1 = BatchNorm(512, dtype)
        self.dp1 = Dropout(0.5)
        self.convs2 = Conv1x1(512, 256, dtype)
        self.bns2 = BatchNorm(256, dtype)
        self.convs3 = Conv1x1(256, cls_dim)  # f32: no compute dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers (``common.init_weights``)."""
        init_weights(self, generator)

    def head(self, pts: torch.Tensor, seg_feats: torch.Tensor, center: torch.Tensor,
             cls_label_one_hot: Optional[torch.Tensor] = None, rngs: Rngs = None
             ) -> torch.Tensor:
        x = seg_feats  # (B, G, 3C) f32
        globs: List[torch.Tensor] = [torch.amax(x, dim=1), torch.mean(x, dim=1)]
        if self.with_label:
            globs.append(self.label_conv(cls_label_one_hot).float())
        x_global = torch.cat(globs, dim=-1)  # (B, 2 * 3C [+ 64]) f32
        f_level_0 = self.propagation_0(pts, center, pts, x)  # (B, N, 1024)
        # convs1 over [f_level_0 | x_global broadcast over N]: the global
        # columns act once a cloud and are added by broadcast (_ConcatDense
        # with g_last, common.py:373-397)
        w = self.convs1.weight[..., 0]
        dt = self.compute_dtype or w.dtype
        cx = f_level_0.shape[-1]
        h = dense(f_level_0, w[:, :cx], None, dt)
        h = h + dense(x_global, w[:, cx:], None, dt)[:, None, :]
        h = h + self.convs1.bias.to(h.dtype)
        h = self.dp1(F.relu(self.bns1(h)), rngs)
        h = F.relu(self.bns2(self.convs2(h)))
        return torch.log_softmax(self.convs3(h).float(), dim=-1)


BACKBONE_WIDTHS = ("trans_dim", "depth", "num_heads", "encoder_dims")


def _backbone_kwargs(cfg) -> dict:
    """The backbone's arguments: groups and dtype, and the published widths
    unless the config narrows them (``BACKBONE_WIDTHS``, ``fetch_idx``)."""
    kw = dict(num_group=int(cfg.get("num_group", 128)),
              group_size=int(cfg.get("group_size", 32)), dtype=dtype_from_cfg(cfg))
    kw.update({k: int(cfg[k]) for k in BACKBONE_WIDTHS if k in cfg})
    if "fetch_idx" in cfg:
        kw["fetch_idx"] = tuple(int(i) for i in cfg["fetch_idx"])
    return kw


@MODELS.register_module()
class PartSegTransformer(_SegHead):
    """ShapeNetPart model (reference part_segmentation/models/pt.py get_model):
    (B, N, 3) points and the (B, 16) object-category one-hot -> (B, N, 50)
    f32 log-probs. Training mode (``model.train()``) draws the drop paths
    and the head's dropout from ``rngs`` ('droppath', 'dropout')."""

    def __init__(self, config: Any):
        cfg = as_cfg(config)
        super().__init__(int(cfg.get("cls_dim", 50)), True, **_backbone_kwargs(cfg))

    def forward(self, pts: torch.Tensor, cls_label_one_hot: torch.Tensor,
                rngs: Rngs = None) -> torch.Tensor:
        seg_feats, center = self.backbone(pts, rngs)
        return self.head(pts, seg_feats, center, cls_label_one_hot, rngs)


@MODELS.register_module()
class SemSegTransformer(_SegHead):
    """S3DIS model (reference semantic_segmentation/models/pt.py get_model):
    (B, N, 3) block points -> (B, N, 13) f32 log-probs."""

    def __init__(self, config: Any):
        cfg = as_cfg(config)
        super().__init__(int(cfg.get("cls_dim", 13)), False, **_backbone_kwargs(cfg))

    def forward(self, pts: torch.Tensor, rngs: Rngs = None) -> torch.Tensor:
        seg_feats, center = self.backbone(pts, rngs)
        return self.head(pts, seg_feats, center, None, rngs)


def nll_seg_loss(log_probs: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NLL of (B, N, C) log-probs at the (B, N) labels, the mean, or with
    per-class weights ``sum(nll * w) / max(sum(w), 1e-8)``
    (``segmentation.py:186-195``; S3DIS weighs by inverse frequency).

    Over R ranks (each of the same rows) the gradients are averaged
    (``train_state._update``): the mean needs nothing more, and the weighted
    loss is R times this rank's numerator over the global ``sum(w)``
    (detached), so that the ranks' mean is the global batch's loss and
    gradient."""
    t = target.long()
    nll = -torch.gather(log_probs, -1, t[..., None])[..., 0]
    if weight is None:
        return nll.mean()
    w = weight[t]
    total = all_reduce_sum(torch.sum(w).detach())
    return torch.sum(nll * w) * data_count() / torch.clamp_min(total, 1e-8)
