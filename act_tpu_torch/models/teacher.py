"""The frozen, deep-prompt-tuned 2D Transformer teacher: ViT, CLIP or BERT.

Counterpart of ``act_tpu/models/teacher.py:71-190`` (reference
ACTPromptedDiscreteVAEwithVIT.build_visual_embedding and the deep-prompt
forward, models/dvae.py:390-444,536-576, and the BERT variant,
models/dvae.py:652-663): proj_pre -> [prompts | tokens] -> the 2D
Transformer's blocks (the prompts re-spliced at every layer when deep) ->
strip prompts -> proj_post. Per arch (``TEACHER_LAYOUT``):

- 'vit' (timm ViT): pre-LN blocks ``visual_embed.0.N``, positions added at
  every block, a final LayerNorm ``visual_embed.1`` (eps 1e-6);
- 'clip' (CLIP's visual transformer): ``ln_pre`` (``visual_embed.0``) over the
  whole [prompts | tokens] sequence after the concat, QuickGELU blocks
  ``visual_embed.1.N`` with positions added at every block, ``ln_post``
  (``visual_embed.2``) after the prompts are stripped;
- 'bert' (HuggingFace BERT's encoder): post-LN layers
  ``visual_embed.0.layer.N``, token positions added at layer 0 only, the
  deep prompts' positions at every layer, no final norm.

Every arch keeps the JAX forward's per-sample attention (``teacher.py:82-88``:
the reference's deep-prompt CLIP call leaves out the NLD -> LND transpose and
would attend across the batch).

In the reference these parameters are attributes of the tokenizer itself
(``proj_pre``, ``visual_prompt_token``, ``visual_embed.0.N`` ...), so
:func:`add_teacher` puts them on whatever module owns them and
:func:`teacher_forward` runs them; :class:`PromptedTeacher` is the stand-alone
module.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from act_tpu_torch.models.common import (Block, CLIPBlock, Dense, Dropout, LayerNorm,
                                         PostLNBlock, Rngs, trunc_normal_)


PROMPT_DROPOUT = 0.1  # PromptedTeacher.prompt_dropout (teacher.py:90)
# arch -> (the blocks' prefix under the owner, the frozen backbone's prefixes):
# the JAX Stage-I freeze mask is ``blocks_`` and ``norm`` (runner_autoencoder.py:
# 131-135), so CLIP's ln_pre/ln_post (visual_embed.0/.2) stay trainable there
TEACHER_LAYOUT = {"vit": ("visual_embed.0", ("visual_embed.0", "visual_embed.1")),
                  "clip": ("visual_embed.1", ("visual_embed.1",)),
                  "bert": ("visual_embed.0", ("visual_embed.0",))}


def teacher_arch(visual_embed_type) -> str:
    """'clip' for a ``clip_*`` ``visual_embed_type``, else 'vit' (reference
    dvae.py:394-410)."""
    return "clip" if str(visual_embed_type).lower().startswith("clip") else "vit"


class BertEncoder(nn.Module):
    """HuggingFace ``BertEncoder``'s layout: the layers at ``layer.N``."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = nn.ModuleList(PostLNBlock(dim, num_heads, dtype=dtype)
                                   for _ in range(depth))


def add_teacher(m: nn.Module, embed_dim: int, depth: int, num_heads: int,
                tokens_dims: int, num_prompt_token: int, use_deep_prompt: bool,
                arch: str = "vit", dtype: Optional[torch.dtype] = None) -> None:
    """Register the teacher's parameters on ``m`` in the reference layout."""
    if arch not in TEACHER_LAYOUT:
        raise ValueError(f"teacher arch {arch!r} is not one of {sorted(TEACHER_LAYOUT)}")
    P, D = num_prompt_token, embed_dim
    m.teacher_arch = arch
    m.num_prompt_token, m.use_deep_prompt = P, use_deep_prompt
    m.visual_pos_embed = nn.Sequential(Dense(3, 128, dtype=dtype), nn.GELU(),
                                       Dense(128, D, dtype=dtype))
    m.proj_pre = Dense(tokens_dims, D, dtype=dtype)
    m.proj_post = Dense(D, tokens_dims, dtype=dtype)
    if P > 0:
        m.visual_prompt_token = nn.Parameter(torch.empty(1, P, D))
        m.visual_prompt_pos = nn.Parameter(torch.empty(1, P, D))
        if use_deep_prompt:
            m.deep_prompt_tokens = nn.Parameter(torch.empty(depth - 1, P, D))
            m.deep_prompt_pos = nn.Parameter(torch.empty(depth - 1, P, D))
    m.prompt_dropout = Dropout(PROMPT_DROPOUT)
    if arch == "vit":
        # timm ViT blocks: qkv bias, LayerNorm eps 1e-6 (teacher.py:101-103, 187)
        m.visual_embed = nn.Sequential(
            nn.Sequential(*[Block(D, num_heads, qkv_bias=True, dtype=dtype, ln_eps=1e-6)
                            for _ in range(depth)]),
            LayerNorm(D, eps=1e-6))
    elif arch == "clip":  # Sequential(ln_pre, resblocks, ln_post), dvae.py:396-403
        m.visual_embed = nn.Sequential(
            LayerNorm(D, eps=1e-5),
            nn.Sequential(*[CLIPBlock(D, num_heads, dtype=dtype) for _ in range(depth)]),
            LayerNorm(D, eps=1e-5))
    else:  # Sequential(BertModel.encoder), dvae.py:660-663
        m.visual_embed = nn.Sequential(BertEncoder(D, depth, num_heads, dtype))


def init_teacher_prompts(m: nn.Module, generator: torch.Generator) -> None:
    """The prompts' init (truncated normal, std 0.02)."""
    with torch.no_grad():
        for name in ("visual_prompt_token", "visual_prompt_pos",
                     "deep_prompt_tokens", "deep_prompt_pos"):
            if hasattr(m, name):
                trunc_normal_(getattr(m, name), 0.02, generator)


def teacher_parts(m: nn.Module):
    """(the blocks, CLIP's ln_pre or None, the final norm or None)."""
    ve = m.visual_embed
    if m.teacher_arch == "vit":
        return ve[0], None, ve[1]
    if m.teacher_arch == "clip":
        return ve[1], ve[0], ve[2]
    return ve[0].layer, None, None


def teacher_forward(m: nn.Module, tokens: torch.Tensor, center: torch.Tensor,
                    rngs: Rngs = None) -> torch.Tensor:
    """tokens (B, G, tokens_dims), centers (B, G, 3) -> (B, G, tokens_dims).

    In training mode the prompts go through prompt dropout (the 'dropout'
    stream), at layer 0 and at every deep layer."""
    B = tokens.shape[0]
    P = m.num_prompt_token
    blocks, pre, post = teacher_parts(m)
    pos_every_layer = m.teacher_arch != "bert"
    pos = m.visual_pos_embed(center)
    x = m.proj_pre(tokens)
    D = x.shape[-1]
    if P > 0:
        prompt = m.prompt_dropout(m.visual_prompt_token.expand(B, P, D), rngs)
        x = torch.cat([prompt, x], dim=1)
        pos = torch.cat([m.visual_prompt_pos.expand(B, P, D), pos], dim=1)
    if pre is not None:
        # CLIP's ln_pre on [prompts | tokens], before any position is added
        # (teacher.py:138-141): the deep prompts of later layers skip it
        x = pre(x)
    if P > 0 and m.use_deep_prompt:
        # each layer's prompt-row outputs are discarded, so only the token
        # rows are queried (q_keep_from=P, teacher.py:151-176)
        tok, tok_pos = x[:, P:], pos[:, P:]
        for i, blk in enumerate(blocks):
            if i == 0:
                pr, prpos = x[:, :P], pos[:, :P]
            else:
                pr = m.prompt_dropout(m.deep_prompt_tokens[i - 1].expand(B, P, D), rngs)
                prpos = m.deep_prompt_pos[i - 1].expand(B, P, D)
            t_in = tok + tok_pos if pos_every_layer or i == 0 else tok
            tok = blk(torch.cat([pr + prpos, t_in], dim=1), q_keep_from=P)
        x = tok
    else:
        for i, blk in enumerate(blocks):
            if pos_every_layer or i == 0:
                x = x + pos
            x = blk(x)
        x = x[:, P:]
    if post is not None:
        x = post(x)
    return m.proj_post(x)


class PromptedTeacher(nn.Module):
    """The teacher as a module of its own (keys as inside the tokenizer)."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 tokens_dims: int = 384, num_prompt_token: int = 64,
                 use_deep_prompt: bool = True, arch: str = "vit",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        add_teacher(self, embed_dim, depth, num_heads, tokens_dims, num_prompt_token,
                    use_deep_prompt, arch, dtype)

    def forward(self, tokens: torch.Tensor, center: torch.Tensor, rngs: Rngs = None
                ) -> torch.Tensor:
        return teacher_forward(self, tokens, center, rngs)
