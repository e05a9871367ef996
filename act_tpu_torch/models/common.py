"""Shared neural building blocks.

Counterpart of ``act_tpu/models/common.py``: the transformer stack and
decoder, the positional-embedding MLP, the mini-PointNet group encoder and the
DGCNN. Parameters keep the reference PyTorch key layout and shapes
(``encoder.first_conv.0.weight`` is (128, 3, 1), ``attn.qkv.weight`` is
(3C, C), a DGCNN ``layer1.0.weight`` is (256, 256, 1, 1)), so a released
checkpoint loads with ``strict=True``; ``act_tpu_torch.engine.weights``
carries JAX parameters over. Activations are channels-last and every 1x1 conv
is a product on the last axis (``F.linear``), never cuDNN.

Numerics follow the flax modules cast for cast. With a compute ``dtype``
(bf16), a dense layer casts its input and weight to it, emits it, and adds its
bias in it afterwards. LayerNorm, BatchNorm and GroupNorm statistics and the
attention softmax run in f32; Batch/GroupNorm emit the compute dtype. In
training mode (``module.train()``) BatchNorm uses batch statistics and updates
its running statistics as flax does (momentum 0.9, biased variance), and
dropout and drop path draw from the generators passed as ``rngs``
(``{'dropout': ..., 'droppath': ...}``); nothing uses the global RNG. Over
several ranks BatchNorm takes the global batch's statistics and each draw is
the rank's rows of the global batch's draw (``parallel.rand_local``).

Under tensor parallelism (``parallel/tp.py``) the transformer modules
(:class:`Mlp`, :class:`Attention`, :class:`CLIPAttention`,
:class:`CLIPBlock`, :class:`PostLNBlock`) hold one shard of their split
weights and a share of the heads, and their ``model_parallel`` (set by
``tp.shard_module``) is the size of the model group: their column-parallel
inputs pass through ``tp.copy_to_model`` and their row-parallel products
through ``tp.reduce_from_model``, with the bias added once after it. At
``model_parallel`` 1 they run as they always did.
"""
from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from act_tpu_torch import ops
from act_tpu_torch.parallel import all_reduce_sum, data_count, rand_local
from act_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the JAX package
Rngs = Optional[Mapping[str, torch.Generator]]


def dtype_from_cfg(cfg) -> Optional[torch.dtype]:
    """Map a config 'dtype' string to a torch compute dtype (None = float32)."""
    d = cfg.get("dtype", None) if hasattr(cfg, "get") else None
    if d in ("bf16", "bfloat16"):
        return torch.bfloat16
    if d in ("f32", "float32", None):
        return None
    raise ValueError(f"unknown dtype {d}")


def rng(rngs: Rngs, name: str) -> torch.Generator:
    """The generator of stream ``name``; a training-mode draw needs one."""
    if rngs is None or name not in rngs:
        raise ValueError(f"training mode draws from the {name!r} stream: pass "
                         f"rngs={{'{name}': torch.Generator(...)}}")
    return rngs[name]


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor in ``like``'s dtype and device: a python
    float meets a bf16 array in flax as a bf16 constant."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype], model_parallel: int = 1) -> torch.Tensor:
    """flax ``Dense`` casts: x and the (out, in) weight go to ``dtype`` (else
    their promoted type), the product is emitted in it, then the bias is
    added in it. With ``model_parallel`` > 1 the weight is a row-parallel
    shard: the partial products are summed over the model group
    (``tp.reduce_from_model``) before the bias."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, weight.dtype)
    y = F.linear(x.to(dt), weight.to(dt))
    if model_parallel > 1:
        y = reduce_from_model(y)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def model_input(x: torch.Tensor, model_parallel: int) -> torch.Tensor:
    """``x`` as the input of column-parallel weights (``tp.copy_to_model``
    with ``model_parallel`` > 1)."""
    return copy_to_model(x) if model_parallel > 1 else x


class Dense(nn.Linear):
    """``nn.Linear`` parameters with flax ``Dense`` numerics (see :func:`dense`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Conv1x1(nn.Module):
    """A kernel-size-1 ``nn.Conv1d`` (``kernel_dims=1``, weight (out, in, 1))
    or ``nn.Conv2d`` (``kernel_dims=2``, (out, in, 1, 1)) applied
    channels-last as a dense layer."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None, bias: bool = True,
                 kernel_dims: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *([1] * kernel_dims)))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.flatten(1), self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm emitting the promoted type of its input and parameters, as
    flax does (a bf16 residual stream through f32 scales comes out f32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


def _normalize(x32: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               eps: float, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    return (x32 - mean) * (torch.rsqrt(var + eps) * weight) + bias


def _fast_stats(x32: torch.Tensor, dims, keepdim: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's statistics: mean and E[x^2] - E[x]^2, clipped at 0 (biased)."""
    mean = x32.mean(dims, keepdim=keepdim)
    var = torch.clamp_min(x32.square().mean(dims, keepdim=keepdim) - mean.square(), 0.0)
    return mean, var


def _global_stats(x32: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fast_stats`` over the global batch of every data index: the sums of
    x and x^2 and the count, all-reduced in f32 in one tensor by a
    differentiable all-reduce over the data group (its backward sums the
    ranks' gradients), then flax's E[x^2] - E[x]^2. One data index takes
    ``_fast_stats`` itself."""
    if data_count() == 1:
        return _fast_stats(x32, dims)
    count = x32.new_full((1,), float(math.prod(x32.shape[d] for d in dims)))
    sums = all_reduce_sum(torch.cat([x32.sum(dims), x32.square().sum(dims), count]))
    C = x32.shape[-1]
    mean, sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
    return mean, torch.clamp_min(sq - mean.square(), 0.0)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis with flax's arithmetic, in f32 (f64 for f64
    inputs, which flax keeps too), emitted in the compute dtype (else the
    promoted type of x and the parameters).

    Training mode normalizes with the statistics over every other axis and
    updates the running ones as ``0.9 * running + 0.1 * batch`` with the
    biased batch variance (flax ``BatchNorm(momentum=0.9)``; torch's own
    train mode would update with the unbiased one). Over several ranks the
    statistics are those of the global batch (``_global_stats``), what the
    JAX package's BatchNorm computes on a batch-sharded mesh; so
    ``--sync_bn`` has nothing to add. ``torch.nn.SyncBatchNorm`` is not
    used: it refuses CPU tensors and takes another variance formula."""

    def __init__(self, num_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = _global_stats(x32, tuple(range(x.dim() - 1)))
            with torch.no_grad():
                m = 1.0 - self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return _normalize(x32, mean, var, self.eps, self.weight, self.bias).to(out)


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm`` channels-last: statistics per batch element and
    channel group over every non-batch axis, in f32 (f64 for f64), emitted
    in the compute dtype (else the promoted type)."""

    def __init__(self, num_groups: int, num_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_groups, num_channels, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        G, C = self.num_groups, self.num_channels
        x32 = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
            x.shape[0], -1, G, C // G)
        mean, var = _fast_stats(x32, (1, 3), keepdim=True)
        y = _normalize(x32, mean, var, self.eps, self.weight.reshape(G, C // G),
                       self.bias.reshape(G, C // G))
        return y.reshape(x.shape).to(out)


class LeakyReLU(nn.Module):
    """``where(x >= 0, x, slope * x)`` with the slope in x's dtype (flax)."""

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * scalar(self.negative_slope, x))


class DropPath(nn.Module):
    """Stochastic depth: in training mode each sample's residual branch is
    kept with probability 1 - rate and scaled by 1 / (1 - rate) in the
    branch's dtype (``common.py:55-79``)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor, rngs: Rngs = None) -> Optional[torch.Tensor]:
        """The uniforms of a call on ``x``, one a sample; None where the call
        keeps every sample (eval mode, rate 0)."""
        if not self.training or self.rate == 0.0:
            return None
        return rand_local((x.shape[0],) + (1,) * (x.dim() - 1), rng(rngs, "droppath"))

    def scale(self, x: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
        """``x`` with the samples whose uniform ``u`` is at least 1 - rate
        dropped and the others scaled by 1 / (1 - rate)."""
        if u is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / scalar(keep, x), scalar(0.0, x))

    def forward(self, x: torch.Tensor, rngs: Rngs = None) -> torch.Tensor:
        return self.scale(x, self.draw(x, rngs))


class Dropout(nn.Module):
    """Elementwise dropout drawn from the 'dropout' stream, scaling the kept
    values by 1 / (1 - rate) in x's dtype (``FastDropout``, ``common.py:608-625``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rngs: Rngs = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        u = rand_local(x.shape, rng(rngs, "dropout"))
        return torch.where(u >= self.rate, x / scalar(1.0 - self.rate, x), scalar(0.0, x))


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
        self.model_parallel = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp, fc2 = self.model_parallel, self.fc2
        h = F.gelu(self.fc1(model_input(x, tp)), approximate=self.approximate)
        return dense(h, fc2.weight, fc2.bias, fc2.compute_dtype, tp)


class Attention(nn.Module):
    """Multi-head self-attention (reference models/act.py:44-69).

    q, k, v and the scores are emitted in the compute dtype (else the
    weights' dtype, as flax's fused projections do); the softmax runs in f32
    and is cast back to the input's dtype, so the weighted sum of v runs in
    the promoted type, as in ``common.py:186-196``. Explicit products, not
    ``scaled_dot_product_attention``, which rounds elsewhere. ``q_keep_from``
    restricts the queries, and so the output rows, to ``[q_keep_from:]``.
    Sharded (``model_parallel`` > 1), ``qkv`` holds q | k | v of this rank's
    ``num_heads`` heads and ``proj`` their input columns."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.model_parallel = 1

    def forward(self, x: torch.Tensor, q_keep_from: int = 0) -> torch.Tensor:
        B, N, _ = x.shape
        H, tp = self.num_heads, self.model_parallel
        w, b = self.qkv.weight, self.qkv.bias
        C = w.shape[0] // 3  # this rank's heads' width (the model's at T = 1)
        dt = self.qkv.compute_dtype or w.dtype
        x_in = model_input(x, tp)
        if q_keep_from:
            q = dense(x_in[:, q_keep_from:], w[:C], None if b is None else b[:C], dt)
            q = q.reshape(B, N - q_keep_from, H, C // H).transpose(1, 2)
            k, v = dense(x_in, w[C:], None if b is None else b[C:], dt).reshape(
                B, N, 2, H, C // H).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = dense(x_in, w, b, dt).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        return head_proj(attend(q, k, v, self.scale, x.dtype), self.proj.weight,
                         self.proj.bias, self.proj.compute_dtype, tp)


def head_proj(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: Optional[torch.dtype], model_parallel: int = 1) -> torch.Tensor:
    """A projection of the JAX attention (``_QKVProj``, ``_HeadMergeProj``):
    emitted in the compute dtype, else in the weight's (a frozen bf16 weight
    keeps its dtype under an f32 config); row-parallel with
    ``model_parallel`` > 1 (:func:`dense`)."""
    return dense(x, weight, bias, dtype or weight.dtype, model_parallel)


def split_heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, C / H)."""
    B, N, C = y.shape
    return y.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """(B, H, Nq, hd) queries over (B, H, N, hd) keys and values -> the
    merged (B, Nq, C) context. The softmax runs in f32 and is cast to
    ``dtype`` (the attention input's), so the weighted sum of v runs in the
    promoted type (``common.py:186-196``)."""
    attn = torch.matmul(q, k.transpose(-2, -1)) * scale
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(dtype)
    ct = torch.promote_types(attn.dtype, v.dtype)
    ctx = torch.matmul(attn.to(ct), v.to(ct))  # (B, H, Nq, hd)
    B, H, Nq, hd = ctx.shape
    return ctx.transpose(1, 2).reshape(B, Nq, H * hd)


class Block(nn.Module):
    """Pre-LN transformer block with stochastic depth (reference
    models/act.py:72-90, ``common.py:199-230``). ``q_keep_from > 0`` keeps
    only rows ``[q_keep_from:]`` of the output; keys and values still see
    every row."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: Optional[torch.dtype] = None,
                 drop_path: float = 0.0, ln_eps: float = LN_EPS):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, q_keep_from: int = 0, rngs: Rngs = None,
                drawn: Optional[Tuple[Optional[torch.Tensor], ...]] = None) -> torch.Tensor:
        """``drawn``: the drop path's two uniforms (the attention's, then the
        MLP's, :meth:`DropPath.draw`) drawn beforehand, in place of drawing
        them from ``rngs`` here."""
        dp = self.drop_path
        h = self.attn(self.norm1(x), q_keep_from)
        x = x[:, q_keep_from:] + (dp(h, rngs) if drawn is None else dp.scale(h, drawn[0]))
        h = self.mlp(self.norm2(x))
        return x + (dp(h, rngs) if drawn is None else dp.scale(h, drawn[1]))


class CLIPAttention(nn.Module):
    """CLIP's ``nn.MultiheadAttention`` parameters (fused ``in_proj_weight``
    (3C, C) and ``in_proj_bias`` rows q | k | v, ``out_proj``) run per sample
    with :class:`Attention`'s numerics (``clip_block_rules``,
    ``torch_convert.py:168-195``)."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Dense(dim, dim, dtype=dtype)
        self.compute_dtype = dtype
        self.model_parallel = 1

    def forward(self, x: torch.Tensor, q_keep_from: int = 0) -> torch.Tensor:
        H, dt, tp = self.num_heads, self.compute_dtype, self.model_parallel
        w, b = self.in_proj_weight, self.in_proj_bias
        C = w.shape[0] // 3  # this rank's heads' width
        x = model_input(x, tp)
        q, k, v = (split_heads(head_proj(x[:, q_keep_from:] if i == 0 else x,
                                         w[i * C:(i + 1) * C], b[i * C:(i + 1) * C], dt), H)
                   for i in range(3))
        return head_proj(attend(q, k, v, self.scale, x.dtype), self.out_proj.weight,
                         self.out_proj.bias, dt, tp)


class CLIPBlock(nn.Module):
    """CLIP's ResidualAttentionBlock (``act_tpu/models/teacher.py:48-68``):
    pre-LN (eps 1e-5), the fused-projection attention, a QuickGELU MLP
    ``h * sigmoid(1.702 h)`` at every dtype; keys ``ln_1``, ``attn.*``,
    ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``. ``q_keep_from`` as in
    :class:`Block`."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = CLIPAttention(dim, num_heads, dtype)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = nn.ModuleDict(dict(c_fc=Dense(dim, 4 * dim, dtype=dtype),
                                      c_proj=Dense(4 * dim, dim, dtype=dtype)))
        self.model_parallel = 1  # of the MLP (the attention has its own)

    def forward(self, x: torch.Tensor, q_keep_from: int = 0) -> torch.Tensor:
        tp, c_proj = self.model_parallel, self.mlp["c_proj"]
        x = x[:, q_keep_from:] + self.attn(self.ln_1(x), q_keep_from)
        h = self.mlp["c_fc"](model_input(self.ln_2(x), tp))
        return x + dense(h * torch.sigmoid(1.702 * h), c_proj.weight, c_proj.bias,
                         c_proj.compute_dtype, tp)


class PostLNBlock(nn.Module):
    """BERT's post-LN layer (``act_tpu/models/teacher.py:25-45``) in
    HuggingFace's ``BertLayer`` key layout (``bert_block_rules``,
    ``torch_convert.py:255-288``): separate ``attention.self.{query,key,
    value}``, ``attention.output.dense`` and ``.LayerNorm``,
    ``intermediate.dense``, ``output.dense`` and ``.LayerNorm`` (eps 1e-12).
    The MLP's GELU follows :class:`Mlp`'s dtype rule. With ``q_keep_from``
    the first norm takes ``x[:, q_keep_from:] + h``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None, ln_eps: float = 1e-12):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.compute_dtype = dtype
        hidden = int(dim * mlp_ratio)
        self.attention = nn.ModuleDict(dict(
            self=nn.ModuleDict({n: Dense(dim, dim, dtype=dtype) for n in ("query", "key", "value")}),
            output=nn.ModuleDict(dict(dense=Dense(dim, dim, dtype=dtype),
                                      LayerNorm=LayerNorm(dim, eps=ln_eps)))))
        self.intermediate = nn.ModuleDict(dict(dense=Dense(dim, hidden, dtype=dtype)))
        self.output = nn.ModuleDict(dict(dense=Dense(hidden, dim, dtype=dtype),
                                         LayerNorm=LayerNorm(dim, eps=ln_eps)))
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"
        self.model_parallel = 1

    def forward(self, x: torch.Tensor, q_keep_from: int = 0) -> torch.Tensor:
        H, dt, tp = self.num_heads, self.compute_dtype, self.model_parallel
        sa, out = self.attention["self"], self.attention["output"]
        x_in = model_input(x, tp)
        q, k, v = (split_heads(head_proj(x_in[:, q_keep_from:] if n == "query" else x_in,
                                         sa[n].weight, sa[n].bias, dt), H)
                   for n in ("query", "key", "value"))
        h = head_proj(attend(q, k, v, self.scale, x.dtype), out["dense"].weight,
                      out["dense"].bias, dt, tp)
        x = out["LayerNorm"](x[:, q_keep_from:] + h)
        h = F.gelu(self.intermediate["dense"](model_input(x, tp)),
                   approximate=self.approximate)
        o = self.output["dense"]
        return self.output["LayerNorm"](x + dense(h, o.weight, o.bias, o.compute_dtype, tp))


def drop_path_rates(rate: float, depth: int) -> List[float]:
    """The per-block schedule ``linspace(0, rate, depth)``."""
    return [float(r) for r in np.linspace(0, rate, depth)]


class TransformerEncoder(nn.Module):
    """Stack of Blocks with the pos embedding added at every block input,
    ``x = block(x + pos)`` (reference models/act.py:109-112), drop path
    rising linearly from 0 to ``drop_path_rate``. The unrolled stack; a
    scanned JAX checkpoint is unstacked by the weight bridge.

    ``remat`` (JAX's ``nn.remat`` of each block, ``common.py:271``): with
    gradients on, each block runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward pass. Its drop-path uniforms are drawn before
    the call, in the block's own order, and passed in: the recompute keeps
    them, and the step equals the one without ``remat`` bit for bit
    (``preserve_rng_state`` restores the global generators only, not the
    ``rngs`` streams)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 dtype: Optional[torch.dtype] = None, drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype, drop_path=r)
            for r in drop_path_rates(drop_path_rate, depth))
        self.remat = remat

    def forward(self, x: torch.Tensor, pos: torch.Tensor, rngs: Rngs = None,
                return_hidden: Sequence[int] = ()) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """-> (output, the outputs of the blocks listed in ``return_hidden``)."""
        hidden = []
        for i, blk in enumerate(self.blocks):
            if self.remat and torch.is_grad_enabled():
                drawn = (blk.drop_path.draw(x, rngs), blk.drop_path.draw(x, rngs))
                x = checkpoint(blk, x + pos, 0, None, drawn, use_reentrant=False)
            else:
                x = blk(x + pos, rngs=rngs)
            if i in return_hidden:
                hidden.append(x)
        return x, hidden


class TransformerDecoder(nn.Module):
    """Decoder stack + final norm over the trailing ``return_token_num`` rows
    only (the mask-token predictions; reference models/act.py:115-145)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 drop_path_rate: float = 0.1, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype=dtype, drop_path=r)
            for r in drop_path_rates(drop_path_rate, depth))
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, return_token_num: int,
                rngs: Rngs = None) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x + pos, rngs=rngs)
        return self.norm(x[:, -return_token_num:])


class PosEmbedMLP(nn.Sequential):
    """3 -> 128 -> GELU -> dim positional embedding of group centers (the
    reference's pos_embed Sequential, models/act.py:173-177); always exact
    GELU (``common.py:369``)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__(Dense(3, 128, dtype=dtype), nn.GELU(),
                         Dense(128, dim, dtype=dtype))


class GroupEncoder(nn.Module):
    """Mini-PointNet over each local group (reference Encoder,
    models/dvae.py:185-215).

    (B, G, M, 3) -> (B, G, C): pointwise MLP -> max -> concat global -> MLP ->
    max. The conv over ``concat([global, x])`` runs as two products on the
    split weight (``common.py:373`` ``_ConcatDense``): input channels [:256]
    act on the per-group global feature, [256:] on the points. The JAX
    package's conv1/conv3 carry no bias (the BatchNorm after each absorbs
    it); the port keeps the reference keys and never trains those two."""
    FOLDED_BIASES = ("first_conv.0.bias", "second_conv.0.bias")

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
        for name in self.FOLDED_BIASES:
            self.get_parameter(name).requires_grad_(False)

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        B, G, M, _ = point_groups.shape
        x = self.first_conv(point_groups.reshape(B * G, M, 3))  # (BG, M, 256)
        g = torch.amax(x, dim=1)  # (BG, 256)
        conv3 = self.second_conv[0]
        w = conv3.weight[..., 0]
        dt = self.compute_dtype or w.dtype
        cg = g.shape[-1]
        y = dense(x, w[:, cg:], None, dt)
        y = y + dense(g, w[:, :cg], None, dt)[:, None, :]
        y = y + conv3.bias.to(y.dtype)
        for layer in self.second_conv[1:]:
            y = layer(y)
        return torch.amax(y, dim=1).reshape(B, G, self.encoder_channel)


class ConvGNLReLU(nn.Sequential):
    """1x1 conv (no bias) + GroupNorm(4, eps 1e-5) + LeakyReLU(0.2),
    channels-last (``common.py:450-466``); keys ``.0.weight``, ``.1.*``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_dims: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(Conv1x1(in_channels, out_channels, dtype, bias=False,
                                 kernel_dims=kernel_dims),
                         GroupNorm(4, out_channels, dtype), LeakyReLU(0.2))


class DGCNN(nn.Module):
    """Dynamic graph CNN over group centers (reference models/dvae.py:26-117,
    ``common.py:469-518``): four rounds of k=4 graph features in coordinate
    space (one kNN graph, built once from the fixed centers), each a
    conv/GroupNorm/LeakyReLU and a max over the neighbours; the four scales
    concatenate (2304 channels) into the output projection. The neighbour
    features come from ``ops.gather_rows`` (exact copies, as the TPU's one-hot
    product gives; its backward sums each row's gradients in ascending order,
    the kernel of ``csrc/rows.cu`` on the card, so runs repeat bit for bit on
    the card as on the CPU). The four rounds share one ``ops.row_index``: the
    first backward launch lists each center's sources, the others read it."""

    def __init__(self, in_channels: int, output_channel: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_trans = Conv1x1(in_channels, 128, dtype)
        self.layer1 = ConvGNLReLU(256, 256, 2, dtype)
        self.layer2 = ConvGNLReLU(512, 512, 2, dtype)
        self.layer3 = ConvGNLReLU(1024, 512, 2, dtype)
        self.layer4 = ConvGNLReLU(1024, 1024, 2, dtype)
        self.layer5 = ConvGNLReLU(2304, output_channel, 1, dtype)

    def forward(self, f: torch.Tensor, coor: torch.Tensor) -> torch.Tensor:
        """f: (B, G, C) features, coor: (B, G, 3) centers -> (B, G, out)."""
        idx = ops.graph_feature_idx(coor, coor, 4)  # (B, G, k)
        B, G, k = idx.shape
        rows = ops.row_index(idx.reshape(B, G * k), G)  # one list of sources for the 4 rounds
        f = self.input_trans(f)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            C = f.shape[-1]
            nbr = ops.gather_rows(f, rows).reshape(B, G, k, C)
            self_f = f[:, :, None, :].expand_as(nbr)
            f = torch.amax(layer(torch.cat([nbr - self_f, self_f], dim=-1)), dim=2)
            feats.append(f)
        return self.layer5(torch.cat(feats, dim=-1))


class FoldingDecoder(nn.Module):
    """FoldingNet group decoder (reference Decoder, models/dvae.py:217-275;
    ``common.py:521-584``).

    (B, G, C) -> coarse (B, G, M/4, 3), fine (B, G, M, 3): ``mlp`` (C -> 1024
    -> 1024 -> 3 M/4) emits the coarse points; ``final_conv`` runs over
    [global feature | 2x2 folding seed | repeated coarse point] and its
    offsets move the repeated coarse points. The global-feature columns of
    ``final_conv.0`` act once a group and are added by broadcast
    (``_ConcatDense``, ``common.py:373-397``). ``final_conv.0``/``.3`` keep
    the reference's bias keys; the JAX package folds them into the BatchNorm
    means, so they are zero and never trained. ``mlp.4`` and ``final_conv.6``
    run in f32 (no compute dtype), so coarse and fine come out f32."""
    FOLDED_BIASES = ("final_conv.0.bias", "final_conv.3.bias")

    def __init__(self, encoder_channel: int, num_fine: int, grid_size: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_fine % grid_size ** 2:
            raise ValueError(f"num_fine {num_fine} is not a multiple of {grid_size ** 2}")
        self.grid_size, self.num_fine = grid_size, num_fine
        self.num_coarse = num_fine // grid_size ** 2
        self.compute_dtype = dtype
        self.mlp = nn.Sequential(Dense(encoder_channel, 1024, dtype=dtype), nn.ReLU(),
                                 Dense(1024, 1024, dtype=dtype), nn.ReLU(),
                                 Dense(1024, 3 * self.num_coarse))
        self.final_conv = nn.Sequential(
            Conv1x1(encoder_channel + 3 + 2, 512, dtype), BatchNorm(512, dtype), nn.ReLU(),
            Conv1x1(512, 512, dtype), BatchNorm(512, dtype), nn.ReLU(), Conv1x1(512, 3))
        for name in self.FOLDED_BIASES:
            self.get_parameter(name).requires_grad_(False)

    def forward(self, feature_global: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, G, C = feature_global.shape
        s = self.grid_size ** 2
        fg = feature_global.reshape(B * G, C)
        coarse = self.mlp(fg).reshape(B * G, self.num_coarse, 3)
        a = torch.linspace(-0.05, 0.05, self.grid_size, device=fg.device)
        # seed k = (a[k % g], a[k // g]), as the reference's folding_seed
        seed = torch.stack([a.repeat(self.grid_size), a.repeat_interleave(self.grid_size)], -1)
        seed = seed.repeat(self.num_coarse, 1).expand(B * G, self.num_fine, 2)
        point_feat = torch.repeat_interleave(coarse, s, dim=1)  # (BG, num_fine, 3)
        conv0 = self.final_conv[0]
        w = conv0.weight[..., 0]
        dt = self.compute_dtype or w.dtype
        h = dense(torch.cat([seed, point_feat], dim=-1), w[:, C:], None, dt)
        h = h + dense(fg, w[:, :C], None, dt)[:, None, :]
        h = h + conv0.bias.to(h.dtype)
        for layer in self.final_conv[1:-1]:
            h = layer(h)
        fine = self.final_conv[-1](h) + point_feat
        return (coarse.reshape(B, G, self.num_coarse, 3),
                fine.reshape(B, G, self.num_fine, 3))


def gumbel_softmax_from_u(u: torch.Tensor, logits: torch.Tensor, tau: float = 1.0,
                          hard: bool = False) -> torch.Tensor:
    """Gumbel-softmax over the last axis from given uniform draws
    (``common.py:636-647``): softmax((logits - log(-log(u))) / tau); ``hard``
    gives the one-hot of its argmax forward with the soft gradient (straight
    through)."""
    y = torch.softmax((logits + (-torch.log(-torch.log(u)))) / tau, dim=-1)
    if hard:
        y_hard = torch.zeros_like(y).scatter_(-1, torch.argmax(y, dim=-1, keepdim=True), 1.0)
        y = y + (y_hard - y).detach()
    return y


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal (+-2 std) with variance 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax ``truncated_normal(stddev=std, lower=-2 std, upper=2 std)``."""
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
            elif isinstance(m, CLIPAttention):
                lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm1d):
                    m.reset_running_stats()
