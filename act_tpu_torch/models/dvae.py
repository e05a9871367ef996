"""The discrete VAE tokenizer family (Stage I of ACT).

Counterpart of ``act_tpu/models/dvae.py`` (reference models/dvae.py:278-615):
Group -> GroupEncoder -> DGCNN_1 -> Gumbel-softmax over the codebook ->
[frozen prompted ViT teacher] -> DGCNN_2 -> FoldingNet decoder; the loss is
Chamfer-L1 of the coarse and the fine groups plus KL(mean token posterior ||
uniform).

``ACTPromptedDiscreteVAEwithVIT`` is also Stage II's frozen tokenizer, which
only runs :meth:`forward_tokenizer_features`. In flax a submodule that is never
called has no parameters, so the JAX Stage-II tokenizer has no ``decoder``;
``decoder=False`` builds it the same way here; :func:`stage_two_tokenizer`
builds it and refuses a BERT dVAE config.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch import nn

from act_tpu_torch import ops
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.common import (DGCNN, FoldingDecoder, GroupEncoder, Rngs,
                                         dtype_from_cfg, gumbel_softmax_from_u,
                                         init_weights, rng)
from act_tpu_torch.models.teacher import (add_teacher, init_teacher_prompts, teacher_arch,
                                          teacher_forward)
from act_tpu_torch.parallel.mesh import rand_local
from act_tpu_torch.utils.config import as_cfg


class _DVAEBase(nn.Module):
    """The dVAE graph; ``_add_teacher`` decides whether a teacher sits between
    the codebook and dgcnn_2."""

    def __init__(self, config: Any, decoder: bool = True):
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
        if decoder:
            self.decoder = FoldingDecoder(cfg.decoder_dims, cfg.group_size, dtype=dtype)
        self.has_teacher = False
        self._add_teacher(cfg, dtype)

    def _add_teacher(self, cfg, dtype) -> None:
        pass

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: lecun-normal
        kernels, N(0, 1) codebook, truncated-normal (std 0.02) prompts."""
        init_weights(self, generator)
        with torch.no_grad():
            self.codebook.normal_(0.0, 1.0, generator=generator)
        init_teacher_prompts(self, generator)

    def _teach(self, tokens: torch.Tensor, center: torch.Tensor, rngs: Rngs) -> torch.Tensor:
        return teacher_forward(self, tokens, center, rngs) if self.has_teacher else tokens

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
        feature = self._teach(self.codebook[ids.long()], center, rngs)
        if return_global:
            feature = self.dgcnn_2(feature, center)
        return feature

    def forward(self, inp: torch.Tensor, temperature: float = 1.0, hard: bool = False,
                rngs: Rngs = None, gumbel_u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """The reconstruction forward (``dvae.py:107-133``): (B, N, 3) clouds
        -> (whole_coarse (B, G*M/4, 3), whole_fine (B, G*M, 3), coarse (B, G,
        M/4, 3), fine (B, G, M, 3), neighborhood (B, G, M, 3), logits (B, G,
        num_tokens)); the two whole clouds carry no gradient.

        The uniform draws of the soft Gumbel sample come from the 'gumbel'
        stream, or are ``gumbel_u`` (replaying JAX's sown draws). The soft
        one-hot times the codebook is an f32 product."""
        neighborhood, center = ops.group_points(inp, self.num_group, self.group_size)
        logits = self.encode_logits(neighborhood, center)
        if gumbel_u is None:
            g = rng(rngs, "gumbel")
            gumbel_u = torch.clamp_min(rand_local(logits.shape, g), 1e-10)
        soft_one_hot = gumbel_softmax_from_u(gumbel_u, logits, tau=temperature, hard=hard)
        sampled = torch.matmul(soft_one_hot, self.codebook)
        feature = self.dgcnn_2(self._teach(sampled, center, rngs), center)
        coarse, fine = self.decoder(feature)
        B = inp.shape[0]
        whole_fine = (fine + center[:, :, None, :]).reshape(B, -1, 3).detach()
        whole_coarse = (coarse + center[:, :, None, :]).reshape(B, -1, 3).detach()
        return whole_coarse, whole_fine, coarse, fine, neighborhood, logits

    def recon_loss(self, ret) -> torch.Tensor:
        """Chamfer-L1 of the coarse and of the fine groups against the input
        groups (``dvae.py:139-146``)."""
        _, _, coarse, fine, group_gt, _ = ret
        B, G = coarse.shape[:2]
        group_gt = group_gt.reshape(B * G, -1, 3)
        return (ops.chamfer_distance_l1(coarse.reshape(B * G, -1, 3), group_gt)
                + ops.chamfer_distance_l1(fine.reshape(B * G, -1, 3), group_gt))

    def get_loss(self, ret, gt=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(recon, KL divergence of the batch-mean token posterior from the
        uniform one, ``F.kl_div(log_qy, log_uniform, log_target=True,
        'batchmean')``; ``dvae.py:148-160``)."""
        logits = ret[-1]  # (B, G, V)
        mean_softmax = torch.mean(torch.softmax(logits, dim=-1), dim=1)  # (B, V)
        log_qy = torch.log(mean_softmax + 1e-20)
        log_uniform = math.log(1.0 / self.num_tokens)
        kld = torch.sum(math.exp(log_uniform) * (log_uniform - log_qy)) / log_qy.shape[0]
        return self.recon_loss(ret), kld


@MODELS.register_module()
class DiscreteVAE(_DVAEBase):
    """Point-BERT-style tokenizer with no cross-modal teacher (reference
    models/dvae.py:278-357; ``cfgs/autoencoder/pointbert_dvae.yaml``)."""


def _add_prompted_teacher(m: nn.Module, cfg, dtype, arch: str) -> None:
    m.has_teacher = True
    add_teacher(m, int(cfg.visual_embed_dim), int(cfg.get("visual_embed_depth", 12)),
                int(cfg.get("visual_embed_heads", 12)), cfg.tokens_dims,
                cfg.num_prompt_token, cfg.use_deep_prompt, arch=arch, dtype=dtype)


@MODELS.register_module()
class ACTPromptedDiscreteVAEwithVIT(_DVAEBase):
    """dVAE with a frozen, deep-prompt-tuned 2D image Transformer between the
    codebook and dgcnn_2 (``visual_embed_pos=after_dgcnn1``): CLIP's visual
    transformer for a ``clip_*`` ``visual_embed_type``, else a timm ViT
    (reference dvae.py:394-410). ``visual_embed_dim: none`` leaves the
    teacher out."""

    def _add_teacher(self, cfg, dtype) -> None:
        ved = cfg.get("visual_embed_dim", "none")
        if not (ved is None or str(ved).lower() in ("none", "null", "")):
            _add_prompted_teacher(self, cfg, dtype, teacher_arch(
                cfg.get("visual_embed_type", "vit_base_patch16_224")))


@MODELS.register_module()
class ACTPromptedDiscreteVAEwithBERT(_DVAEBase):
    """The same with a frozen BERT-style (post-LN) language-model teacher
    (reference models/dvae.py:617-857; ``act_tpu/models/dvae.py:203-219``)."""

    def _add_teacher(self, cfg, dtype) -> None:
        _add_prompted_teacher(self, cfg, dtype, "bert")


def stage_two_tokenizer(dvae_cfg) -> ACTPromptedDiscreteVAEwithVIT:
    """Stage II's frozen tokenizer (no decoder): ``ACTPromptedDiscreteVAEwithVIT``
    whatever ``dvae_config.NAME`` says, as the JAX package builds it
    (``act_tpu/models/act.py:371-372, 501``), so a ViT or CLIP Stage-I
    checkpoint loads strict. A ``...withBERT`` config raises: the JAX package
    would load its BERT layers into pre-LN ViT blocks with a random final
    norm, without an error, and distil from another function than the one
    Stage I trained (ROADMAP.md §3, fault (a))."""
    if "bert" in str(as_cfg(dvae_cfg).get("NAME", "")).lower():
        raise ValueError(
            f"dvae_config.NAME = {dvae_cfg.get('NAME')}: Stage II's tokenizer is "
            "ACTPromptedDiscreteVAEwithVIT for every dvae_config (act_tpu/models/act.py:371), "
            "so a BERT teacher's post-LN layers would run as pre-LN ViT blocks with a random "
            "final norm (fault (a) of the JAX package, ROADMAP.md section 3); the port refuses "
            "a BERT tokenizer in Stage II")
    return ACTPromptedDiscreteVAEwithVIT(dvae_cfg, decoder=False)
