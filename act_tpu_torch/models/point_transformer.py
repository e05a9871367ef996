"""PointTransformer, the downstream classifier.

Counterpart of ``act_tpu/models/point_transformer.py`` (reference
models/act.py:727-910): Group -> GroupEncoder -> ViT blocks -> concat[cls
token, max-pool of patch tokens] -> head. ``transfer_type`` picks the head:
'linear' a single dense layer, every other type the mlp-3 head; 'side' adds
the side-tuning encoder and its blend. In training mode (``model.train()``)
BatchNorm uses batch statistics and updates its running ones, the blocks
drop paths at ``drop_path_rate`` and the head drops out, drawing from the
'droppath' and 'dropout' generators passed as ``rngs``. ``trainable`` is
the freezing rule of each transfer type, ``get_loss_acc`` the finetune loss.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (BatchNorm, Dense, Dropout, GroupEncoder,
                                         PosEmbedMLP, Rngs, TransformerEncoder,
                                         dtype_from_cfg, init_weights)
from act_tpu_torch.utils.config import as_cfg

TRANSFER_TYPES = ("full", "linear", "mlp-3", "side", "bit-fit")


class Head(nn.Sequential):
    """A classification head's layers in order; its dropouts draw from the
    'dropout' generator of ``rngs``."""

    def forward(self, x: torch.Tensor, rngs: Rngs = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, rngs) if isinstance(layer, Dropout) else layer(x)
        return x


class Mlp3Head(Head):
    """Linear-BN-ReLU-Dropout x2 -> Linear, in f32 (the reference's 'original
    head', models/act.py:778-788); indices 0/1/4/5/8 hold the parameters."""

    def __init__(self, in_dim: int, cls_dim: int):
        super().__init__(
            Dense(in_dim, 256), BatchNorm(256), nn.ReLU(), Dropout(0.5),
            Dense(256, 256), BatchNorm(256), nn.ReLU(), Dropout(0.5),
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
        self.blocks = TransformerEncoder(C, cfg.depth, cfg.num_heads, dtype=dtype,
                                         drop_path_rate=float(cfg.get("drop_path_rate", 0.0)))
        self.norm = nn.LayerNorm(C, eps=1e-5)
        if self.transfer_type == "linear":
            self.cls_head_finetune = Head(Dense(2 * C, self.cls_dim))
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

    def _trunk(self, tokens: torch.Tensor, center: torch.Tensor, rngs: Rngs = None
               ) -> torch.Tensor:
        """Tokens (B, G, C) and centers -> normed (B, 1 + G, C), f32. The f32
        cls token promotes the residual stream to f32."""
        B = tokens.shape[0]
        cls_tok = self.cls_token.expand(B, -1, -1)
        cls_pos = self.cls_pos.expand(B, -1, -1)
        pos = torch.cat([cls_pos, self.pos_embed(center)], dim=1)
        x = torch.cat([cls_tok, tokens], dim=1)
        return self.norm(self.blocks(x, pos, rngs=rngs)[0])

    def _tokens(self, neighborhood: torch.Tensor) -> torch.Tensor:
        tokens = self.encoder(neighborhood)
        return self.reduce_dim(tokens) if self.use_reduce else tokens

    def forward(self, pts: torch.Tensor, rngs: Rngs = None) -> torch.Tensor:
        """(B, N, 3) points -> (B, cls_dim) f32 logits. Training mode draws
        from ``rngs`` ('droppath' where drop_path_rate > 0, 'dropout' for
        the mlp-3 head)."""
        return self.forward_grouped(*ops.group_points(pts, self.num_group,
                                                      self.group_size), rngs=rngs)

    def forward_grouped(self, neighborhood: torch.Tensor, center: torch.Tensor,
                        rngs: Rngs = None) -> torch.Tensor:
        """The forward after grouping: (B, G, M, 3) groups, (B, G, 3) centers
        -> logits."""
        x = self._trunk(self._tokens(neighborhood), center, rngs)
        patches = x[:, 1:]
        if self.transfer_type == "side":
            side_out = self.side_projection(self.side(neighborhood))
            alpha = torch.sigmoid(self.side_alpha)
            patches = alpha * patches + (1 - alpha) * side_out
        concat_f = torch.cat([x[:, 0], torch.amax(patches, dim=1)], dim=-1)
        return self.cls_head_finetune(concat_f, rngs)

    def extract_feature(self, pts: torch.Tensor) -> torch.Tensor:
        """[cls | maxpool] feature (B, 2C) for SVM probes and t-SNE."""
        neighborhood, center = ops.group_points(pts, self.num_group,
                                                self.group_size)
        x = self._trunk(self._tokens(neighborhood), center)
        return torch.cat([x[:, 0], torch.amax(x[:, 1:], dim=1)], dim=-1)



def get_loss_acc(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE loss (the mean of -log_softmax at the label) and accuracy in %
    (``act_tpu/models/point_transformer.py:140-147``)."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean() * 100.0
    return loss, acc


def trainable(name: str, transfer_type: str) -> bool:
    """Whether parameter ``name`` trains under ``transfer_type``, the JAX
    package's rule on parameter paths (``point_transformer.py:150-164``,
    reference models/act.py:798-809): 'full' everything; 'linear' and
    'mlp-3' the head and the cls token and position (their names hold
    'cls'); 'side' those and the side-tuning parameters; 'bit-fit' those and
    every bias, norm biases included."""
    if transfer_type == "full":
        return True
    if transfer_type in ("linear", "mlp-3"):
        return "cls" in name
    if transfer_type == "side":
        return "side" in name or "cls" in name
    if transfer_type == "bit-fit":
        return "bias" in name or "cls" in name
    raise ValueError(f"unknown transfer_type {transfer_type}")
