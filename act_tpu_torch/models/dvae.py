"""The prompted dVAE tokenizer, its Stage-II distillation-target path.

Counterpart of ``act_tpu/models/dvae.py:29-105, 170-199``
(``ACTPromptedDiscreteVAEwithVIT``; reference models/dvae.py:360-615):
GroupEncoder -> DGCNN_1 -> hard Gumbel pick over the codebook -> frozen
prompted ViT teacher -> DGCNN_2. The FoldingNet decoder, the reconstruction
forward and the losses belong to Stage I and are not ported yet; a reference
checkpoint's ``decoder.*`` keys are therefore not loaded.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (DGCNN, GroupEncoder, Rngs, dtype_from_cfg,
                                         rng)
from act_tpu_torch.models.teacher import add_teacher, teacher_forward
from act_tpu_torch.utils.config import as_cfg


@MODELS.register_module()
class ACTPromptedDiscreteVAEwithVIT(nn.Module):
    """dVAE with a frozen, deep-prompt-tuned ViT between the codebook and
    dgcnn_2 (``visual_embed_pos=after_dgcnn1``). ``visual_embed_dim: none``
    leaves the teacher out; a ``clip_*`` ``visual_embed_type`` raises (not
    ported yet)."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = as_cfg(config)
        self.group_size = cfg.group_size
        self.num_group = cfg.num_group
        self.num_tokens = cfg.num_tokens
        dtype = dtype_from_cfg(cfg)
        self.encoder = GroupEncoder(cfg.encoder_dims, dtype=dtype)
        self.dgcnn_1 = DGCNN(cfg.encoder_dims, cfg.num_tokens, dtype=dtype)
        self.codebook = nn.Parameter(torch.empty(cfg.num_tokens, cfg.tokens_dims))
        self.dgcnn_2 = DGCNN(cfg.tokens_dims, cfg.decoder_dims, dtype=dtype)
        ved = cfg.get("visual_embed_dim", "none")
        self.has_teacher = not (ved is None or str(ved).lower() in ("none", "null", ""))
        if self.has_teacher:
            embed_type = str(cfg.get("visual_embed_type", "vit_base_patch16_224"))
            add_teacher(self, int(ved), int(cfg.get("visual_embed_depth", 12)),
                        int(cfg.get("visual_embed_heads", 12)), cfg.tokens_dims,
                        cfg.num_prompt_token, cfg.use_deep_prompt,
                        arch="clip" if embed_type.lower().startswith("clip") else "vit",
                        dtype=dtype)

    def encode_logits(self, neighborhood: torch.Tensor, center: torch.Tensor
                      ) -> torch.Tensor:
        """(B, G, M, 3) groups, (B, G, 3) centers -> (B, G, num_tokens) logits."""
        return self.dgcnn_1(self.encoder(neighborhood), center)

    def forward_tokenizer(self, neighborhood: torch.Tensor, center: torch.Tensor
                          ) -> torch.Tensor:
        """Hard token ids (B, G) int32 (reference dvae.py:578-582)."""
        return torch.argmax(self.encode_logits(neighborhood, center), dim=-1).to(torch.int32)

    def forward_tokenizer_features(self, neighborhood: torch.Tensor, center: torch.Tensor,
                                   return_global: bool = True, rngs: Rngs = None,
                                   gumbel_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Distillation targets: hard Gumbel sample -> codebook row -> teacher
        -> dgcnn_2 (reference dvae.py:584-592).

        The ids are ``argmax(logits - log(-log(gumbel_u)))`` when uniform
        draws are given (replaying JAX's sown ``gumbel_u``), else the Gumbel
        kernel's ``gumbel_argmax`` with seed words from the 'gumbel' stream.
        In training mode the BatchNorms use batch statistics and prompt
        dropout is live, as in the reference's train-mode tokenizer."""
        logits = self.encode_logits(neighborhood, center)
        if gumbel_u is not None:
            ids = torch.argmax(logits - torch.log(-torch.log(gumbel_u)), dim=-1)
        else:
            ids = ops.gumbel_argmax(logits, ops.draw_seed(rng(rngs, "gumbel")))
        feature = self.codebook[ids.long()]  # (B, G, tokens_dims)
        if self.has_teacher:
            feature = teacher_forward(self, feature, center, rngs)
        if return_global:
            feature = self.dgcnn_2(feature, center)
        return feature
