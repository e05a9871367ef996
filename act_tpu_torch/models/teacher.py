"""The frozen, deep-prompt-tuned 2D Transformer teacher (ViT arch).

Counterpart of ``act_tpu/models/teacher.py:71-190`` (reference
ACTPromptedDiscreteVAEwithVIT.build_visual_embedding and the deep-prompt
forward, models/dvae.py:390-444,536-576): proj_pre -> [prompts | tokens] ->
ViT blocks (pos added at every layer, the prompts re-spliced at every layer
when deep) -> final LayerNorm -> strip prompts -> proj_post.

In the reference these parameters are attributes of the tokenizer itself
(``proj_pre``, ``visual_prompt_token``, ``visual_embed.0.N`` ...), so
:func:`add_teacher` puts them on whatever module owns them and
:func:`teacher_forward` runs them; :class:`PromptedTeacher` is the stand-alone
module. The 'clip' and 'bert' archs are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from act_tpu_torch.models.common import (Block, Dense, Dropout, LayerNorm, Rngs,
                                         trunc_normal_)


PROMPT_DROPOUT = 0.1  # PromptedTeacher.prompt_dropout (teacher.py:90)


def add_teacher(m: nn.Module, embed_dim: int, depth: int, num_heads: int,
                tokens_dims: int, num_prompt_token: int, use_deep_prompt: bool,
                arch: str = "vit", dtype: Optional[torch.dtype] = None) -> None:
    """Register the teacher's parameters on ``m`` in the reference layout."""
    if arch != "vit":
        raise NotImplementedError(f"teacher arch {arch!r} is not ported yet (vit only)")
    P, D = num_prompt_token, embed_dim
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
    # timm ViT blocks: qkv bias, LayerNorm eps 1e-6 (teacher.py:101-103, 187)
    m.visual_embed = nn.Sequential(
        nn.Sequential(*[Block(D, num_heads, qkv_bias=True, dtype=dtype, ln_eps=1e-6)
                        for _ in range(depth)]),
        LayerNorm(D, eps=1e-6))


def init_teacher_prompts(m: nn.Module, generator: torch.Generator) -> None:
    """The prompts' init (truncated normal, std 0.02)."""
    with torch.no_grad():
        for name in ("visual_prompt_token", "visual_prompt_pos",
                     "deep_prompt_tokens", "deep_prompt_pos"):
            if hasattr(m, name):
                trunc_normal_(getattr(m, name), 0.02, generator)


def teacher_forward(m: nn.Module, tokens: torch.Tensor, center: torch.Tensor,
                    rngs: Rngs = None) -> torch.Tensor:
    """tokens (B, G, tokens_dims), centers (B, G, 3) -> (B, G, tokens_dims).

    In training mode the prompts go through prompt dropout (the 'dropout'
    stream), at layer 0 and at every deep layer."""
    B = tokens.shape[0]
    P = m.num_prompt_token
    blocks, norm = m.visual_embed
    pos = m.visual_pos_embed(center)
    feature = m.proj_pre(tokens)
    if P > 0:
        D = feature.shape[-1]
        prompt = m.prompt_dropout(m.visual_prompt_token.expand(B, P, D), rngs)
        x = torch.cat([prompt, feature], dim=1)
        pos = torch.cat([m.visual_prompt_pos.expand(B, P, D), pos], dim=1)
    else:
        x = feature
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
            tok = blk(torch.cat([pr + prpos, tok + tok_pos], dim=1), q_keep_from=P)
        x = tok
    else:
        for blk in blocks:
            x = blk(x + pos)
        x = x[:, P:]
    return m.proj_post(norm(x))


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
