"""Shared neural building blocks, eval forward only.

Counterpart of ``act_tpu/models/common.py``: the transformer stack, the
positional-embedding MLP and the mini-PointNet group encoder. Parameters keep
the reference PyTorch key layout and shapes (``encoder.first_conv.0.weight``
is (128, 3, 1), ``attn.qkv.weight`` is (3C, C)), so a released checkpoint loads
with ``strict=True``; ``act_tpu_torch.engine.weights`` carries JAX parameters
over. Activations are channels-last and every 1x1 conv is a product on the
last axis (``F.linear``), never cuDNN.

Numerics follow the flax modules cast for cast. With a compute ``dtype``
(bf16), a dense layer casts its input and f32 weight to it, emits it, and adds
its bias in it afterwards. LayerNorm, BatchNorm statistics and the attention
softmax run in f32; BatchNorm emits the compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the JAX package


def dtype_from_cfg(cfg) -> Optional[torch.dtype]:
    """Map a config 'dtype' string to a torch compute dtype (None = float32)."""
    d = cfg.get("dtype", None) if hasattr(cfg, "get") else None
    if d in ("bf16", "bfloat16"):
        return torch.bfloat16
    if d in ("f32", "float32", None):
        return None
    raise ValueError(f"unknown dtype {d}")


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``Dense`` casts: x and the (out, in) weight go to ``dtype`` (else
    their promoted type), the product is emitted in it, then the bias is
    added in it."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, weight.dtype)
    y = F.linear(x.to(dt), weight.to(dt))
    if bias is not None:
        y = y + bias.to(dt)
    return y


class Dense(nn.Linear):
    """``nn.Linear`` parameters with flax ``Dense`` numerics (see :func:`dense`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Conv1x1(nn.Module):
    """A kernel-size-1 ``nn.Conv1d``'s parameters ((out, in, 1) weight, bias)
    applied channels-last as a dense layer."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight[..., 0], self.bias, self.compute_dtype)


class BatchNorm(nn.BatchNorm1d):
    """Eval-mode BatchNorm over the last axis with flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, emitted in the
    compute dtype (else the promoted type of x and the parameters)."""

    def __init__(self, num_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        out = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out)


class Mlp(nn.Module):
    """Transformer MLP (reference models/act.py:25-41): tanh-approximate GELU
    under bf16, exact erf GELU in f32 (``common.py:100``)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features or in_features, dtype=dtype)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """Multi-head self-attention (reference models/act.py:44-69).

    q, k, v and the scores are emitted in the compute dtype; the softmax runs
    in f32 and is cast back to the input's dtype (f32 on the residual path),
    so the weighted sum of v runs in the promoted type, as in
    ``common.py:188-194``. Explicit products, not
    ``scaled_dot_product_attention``, which rounds elsewhere."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.scale
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(x.dtype)
        ct = torch.promote_types(attn.dtype, v.dtype)
        ctx = torch.matmul(attn.to(ct), v.to(ct))  # (B, H, N, hd)
        return self.proj(ctx.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    """Pre-LN transformer block (reference models/act.py:72-90), eval only:
    no dropout, no drop path."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TransformerEncoder(nn.Module):
    """Stack of Blocks with the pos embedding added at every block input,
    ``x = block(x + pos)`` (reference models/act.py:109-112). The unrolled
    stack; a scanned JAX checkpoint is unstacked by the weight bridge."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x + pos)
        return x


class PosEmbedMLP(nn.Sequential):
    """3 -> 128 -> GELU -> dim positional embedding of group centers (the
    reference's pos_embed Sequential, models/act.py:173-177); always exact
    GELU (``common.py:369``)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__(Dense(3, 128, dtype=dtype), nn.GELU(),
                         Dense(128, dim, dtype=dtype))


class GroupEncoder(nn.Module):
    """Mini-PointNet over each local group (reference Encoder,
    models/dvae.py:185-215), eval BatchNorm.

    (B, G, M, 3) -> (B, G, C): pointwise MLP -> max -> concat global -> MLP ->
    max. The conv over ``concat([global, x])`` runs as two products on the
    split weight (``common.py:373`` ``_ConcatDense``): input channels [:256]
    act on the per-group global feature, [256:] on the points."""

    def __init__(self, encoder_channel: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.compute_dtype = dtype
        self.first_conv = nn.Sequential(
            Conv1x1(3, 128, dtype), BatchNorm(128, dtype), nn.ReLU(),
            Conv1x1(128, 256, dtype))
        self.second_conv = nn.Sequential(
            Conv1x1(512, 512, dtype), BatchNorm(512, dtype), nn.ReLU(),
            Conv1x1(512, encoder_channel, dtype))

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        B, G, M, _ = point_groups.shape
        x = self.first_conv(point_groups.reshape(B * G, M, 3))  # (BG, M, 256)
        g = torch.amax(x, dim=1)  # (BG, 256)
        conv3 = self.second_conv[0]
        w = conv3.weight[..., 0]
        cg = g.shape[-1]
        y = dense(x, w[:, cg:], None, self.compute_dtype)
        y = y + dense(g, w[:, :cg], None, self.compute_dtype)[:, None, :]
        y = y + conv3.bias.to(y.dtype)
        for layer in self.second_conv[1:]:
            y = layer(y)
        return torch.amax(y, dim=1).reshape(B, G, self.encoder_channel)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal (+-2 std) with variance 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every dense, conv, norm layer under ``module`` with the
    JAX package's initializers: lecun-normal kernels, zero biases, unit
    scales, BatchNorm statistics mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, Conv1x1)):
                lecun_normal_(m.weight, m.weight.shape[1], generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm1d):
                    m.reset_running_stats()
