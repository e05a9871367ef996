"""PointTransformer, the downstream classifier, eval forward only.

Counterpart of ``act_tpu/models/point_transformer.py`` (reference
models/act.py:727-910): Group -> GroupEncoder -> ViT blocks -> concat[cls
token, max-pool of patch tokens] -> head. ``transfer_type`` picks the head:
'linear' a single dense layer, every other type the mlp-3 head; 'side' adds
the side-tuning encoder and its blend. Training (freezing masks, losses,
dropout, drop path, batch statistics) is not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (BatchNorm, Dense, GroupEncoder,
                                         PosEmbedMLP, TransformerEncoder,
                                         dtype_from_cfg, init_weights)
from act_tpu_torch.utils.config import as_cfg

TRANSFER_TYPES = ("full", "linear", "mlp-3", "side", "bit-fit")


class Mlp3Head(nn.Sequential):
    """Linear-BN-ReLU-Dropout x2 -> Linear, in f32 (the reference's 'original
    head', models/act.py:778-788); indices 0/1/4/5/8 hold the parameters."""

    def __init__(self, in_dim: int, cls_dim: int):
        super().__init__(
            Dense(in_dim, 256), BatchNorm(256), nn.ReLU(), nn.Dropout(0.5),
            Dense(256, 256), BatchNorm(256), nn.ReLU(), nn.Dropout(0.5),
            Dense(256, cls_dim))


@MODELS.register_module()
class PointTransformer(nn.Module):
    def __init__(self, config: Any):
        super().__init__()
        cfg = as_cfg(config)
        self.embed_dim = cfg.embed_dim
        self.cls_dim = cfg.cls_dim
        self.num_group = cfg.num_group
        self.group_size = cfg.group_size
        self.transfer_type = cfg.get("transfer_type", "full")
        if self.transfer_type not in TRANSFER_TYPES:
            raise ValueError(f"unknown transfer_type {self.transfer_type}")
        dtype = dtype_from_cfg(cfg)
        C = cfg.embed_dim

        self.encoder = GroupEncoder(cfg.encoder_dims, dtype=dtype)
        self.use_reduce = cfg.encoder_dims != C
        if self.use_reduce:
            self.reduce_dim = Dense(cfg.encoder_dims, C, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = PosEmbedMLP(C, dtype=dtype)
        self.blocks = TransformerEncoder(C, cfg.depth, cfg.num_heads,
                                         dtype=dtype)
        self.norm = nn.LayerNorm(C, eps=1e-5)
        if self.transfer_type == "linear":
            self.cls_head_finetune = nn.Sequential(Dense(2 * C, self.cls_dim))
        else:
            self.cls_head_finetune = Mlp3Head(2 * C, self.cls_dim)
        if self.transfer_type == "side":
            # Side-Tuning (reference setup_side, models/act.py:811-817)
            self.side_alpha = nn.Parameter(torch.zeros(1))
            self.side = GroupEncoder(C, dtype=dtype)
            self.side_projection = Dense(C, C, bias=False, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers (cls_pos ~ N(0, 1))."""
        init_weights(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            self.cls_pos.normal_(0.0, 1.0, generator=generator)
            if self.transfer_type == "side":
                self.side_alpha.zero_()

    def _trunk(self, tokens: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
        """Tokens (B, G, C) and centers -> normed (B, 1 + G, C), f32. The f32
        cls token promotes the residual stream to f32."""
        B = tokens.shape[0]
        cls_tok = self.cls_token.expand(B, -1, -1)
        cls_pos = self.cls_pos.expand(B, -1, -1)
        pos = torch.cat([cls_pos, self.pos_embed(center)], dim=1)
        x = torch.cat([cls_tok, tokens], dim=1)
        return self.norm(self.blocks(x, pos))

    def _tokens(self, neighborhood: torch.Tensor) -> torch.Tensor:
        tokens = self.encoder(neighborhood)
        return self.reduce_dim(tokens) if self.use_reduce else tokens

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points -> (B, cls_dim) f32 logits."""
        return self.forward_grouped(*ops.group_points(pts, self.num_group,
                                                      self.group_size))

    def forward_grouped(self, neighborhood: torch.Tensor, center: torch.Tensor
                        ) -> torch.Tensor:
        """The forward after grouping: (B, G, M, 3) groups, (B, G, 3) centers
        -> logits."""
        if self.training:
            raise RuntimeError("the PointTransformer port is eval only: call .eval()")
        x = self._trunk(self._tokens(neighborhood), center)
        patches = x[:, 1:]
        if self.transfer_type == "side":
            side_out = self.side_projection(self.side(neighborhood))
            alpha = torch.sigmoid(self.side_alpha)
            patches = alpha * patches + (1 - alpha) * side_out
        concat_f = torch.cat([x[:, 0], torch.amax(patches, dim=1)], dim=-1)
        return self.cls_head_finetune(concat_f)

    def extract_feature(self, pts: torch.Tensor) -> torch.Tensor:
        """[cls | maxpool] feature (B, 2C) for SVM probes and t-SNE."""
        neighborhood, center = ops.group_points(pts, self.num_group,
                                                self.group_size)
        x = self._trunk(self._tokens(neighborhood), center)
        return torch.cat([x[:, 0], torch.amax(x[:, 1:], dim=1)], dim=-1)

