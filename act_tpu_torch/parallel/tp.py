"""Tensor parallelism: Megatron shardings of the transformers over the model groups.

Counterpart of ``act_tpu/parallel/tp.py``. The JAX package annotates the
MLP pair (fc1 / ``c_fc`` column-parallel, fc2 / ``c_proj`` row-parallel)
and the attention (the fused qkv kernel column-parallel, the output
projection row-parallel) over the mesh's ``model`` axis and lets GSPMD
insert the collectives. The port writes them by hand over the T ranks of
a model group (``mesh.initialize_model_parallel``):

- ``copy_to_model`` (Megatron's *f*) is the identity forward and an
  all-reduce of the gradient backward; it sits before each column-parallel
  input, whose gradient each rank holds only its heads' or hidden units'
  part of;
- ``reduce_from_model`` (*g*) all-reduces forward and is the identity
  backward; it sits after each row-parallel product, and the row-parallel
  bias is added once, after it.

The rules (``tp_split``) are written in the port's own state-dict keys:
torch's ``Linear.weight`` is (out, in), the transpose of a flax kernel, so
JAX's ``P(None, 'model')`` is a split of dim 0 here. One difference from
JAX is deliberate: JAX splits the fused (C, 3C) qkv kernel into contiguous
column blocks and GSPMD reshards the product to heads; the port splits it
by heads (rank m takes heads ``[m H/T, (m+1) H/T)`` of each of q, k and
v), so attention runs on its H/T heads with no collective of its own. The
values are the same. Nothing else is split: not the positional MLPs, not
the FoldingNet decoder, not the heads.

``shard_module`` slices a model's weights in place after its weights are
loaded and made equal over the ranks; the optimizer is built after it, so
its moments are shards too. Checkpoints keep the full, one-process layout:
``full_state_dict`` and ``full_optimizer_state_dict`` gather the shards,
``load_full_state_dict`` and ``load_full_optimizer_state_dict`` slice them
back. ``clip_grad_norm_`` clips by the norm of the whole (logical)
gradient, as JAX's clip reads it. At T = 1 every function is the
one-process identity.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from act_tpu_torch.parallel import mesh

COLUMN, ROW, HEADS = "column", "row", "heads"
# key suffix -> split; the suffixes of the modules that run f and g
# (``models.common``: Mlp, Attention, CLIPBlock's mlp, CLIPAttention, PostLNBlock)
_RULES = {
    "mlp.fc1.weight": COLUMN, "mlp.fc1.bias": COLUMN, "mlp.fc2.weight": ROW,
    "attn.qkv.weight": HEADS, "attn.qkv.bias": HEADS, "attn.proj.weight": ROW,
    "mlp.c_fc.weight": COLUMN, "mlp.c_fc.bias": COLUMN, "mlp.c_proj.weight": ROW,
    "attn.in_proj_weight": HEADS, "attn.in_proj_bias": HEADS, "attn.out_proj.weight": ROW,
    "attention.self.query.weight": COLUMN, "attention.self.query.bias": COLUMN,
    "attention.self.key.weight": COLUMN, "attention.self.key.bias": COLUMN,
    "attention.self.value.weight": COLUMN, "attention.self.value.bias": COLUMN,
    "attention.output.dense.weight": ROW,
    "intermediate.dense.weight": COLUMN, "intermediate.dense.bias": COLUMN,
    "output.dense.weight": ROW,
}
# bytes that f and g all-reduced since the last reset (``reset_traffic``)
TRAFFIC = {"bytes": 0, "calls": 0}


def tp_split(key: str) -> Optional[str]:
    """The split of the parameter at state-dict ``key``: ``COLUMN`` (dim 0:
    the output features, and their bias), ``ROW`` (dim 1: the input
    features; the bias stays whole), ``HEADS`` (dim 0 of a fused q | k | v
    weight or bias, a head-aligned block of each third), or None
    (replicated). The counterpart of ``tp_spec_for_path``."""
    for suffix, kind in _RULES.items():
        if key == suffix or key.endswith("." + suffix):
            return kind
    return None


def reset_traffic() -> None:
    TRAFFIC.update(bytes=0, calls=0)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    TRAFFIC["bytes"] += t.numel() * t.element_size()
    TRAFFIC["calls"] += 1
    dist.all_reduce(t, group=mesh.model_group())
    return t


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, SUM of the gradient over the model
    group backward."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: SUM over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """*f* before a column-parallel input (what GSPMD inserts as the
    all-reduce of the replicated input's gradient)."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """*g* after a row-parallel product: the sum of the ranks' partial
    products (the all-reduce GSPMD inserts after ``P('model', None)``)."""
    return _ReduceFromModel.apply(x)


def _shard(t: torch.Tensor, kind: str, T: int, m: int) -> torch.Tensor:
    """Model index m's shard of the full tensor ``t``."""
    if kind == COLUMN:
        return t.chunk(T, 0)[m]
    if kind == ROW:
        return t.chunk(T, 1)[m]
    return t.reshape(3, -1, *t.shape[1:]).chunk(T, 1)[m].reshape(-1, *t.shape[1:])


def _unshard(shards: List[torch.Tensor], kind: str) -> torch.Tensor:
    """The full tensor from the T shards in model-index order."""
    if kind == COLUMN:
        return torch.cat(shards, 0)
    if kind == ROW:
        return torch.cat(shards, 1)
    rest = shards[0].shape[1:]
    return torch.cat([s.reshape(3, -1, *rest) for s in shards], 1).reshape(-1, *rest)


def _full_shape(local: torch.Size, kind: str, T: int) -> torch.Size:
    dim = 1 if kind == ROW else 0
    return torch.Size(local[:dim] + (local[dim] * T,) + local[dim + 1:])


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "model_parallel", 1) > 1


def _tp_modules():
    from act_tpu_torch.models import common
    return (common.Mlp, common.Attention, common.CLIPAttention, common.CLIPBlock,
            common.PostLNBlock)


def _check_divides(name: str, module: nn.Module, T: int) -> None:
    """Raise unless T divides the heads and hidden width ``module`` splits."""
    from act_tpu_torch.models import common
    widths = []
    if isinstance(module, (common.Attention, common.CLIPAttention, common.PostLNBlock)):
        widths.append(("heads", module.num_heads))
    if isinstance(module, common.Mlp):
        widths.append(("hidden width", module.fc1.out_features))
    if isinstance(module, common.CLIPBlock):
        widths.append(("hidden width", module.mlp["c_fc"].out_features))
    if isinstance(module, common.PostLNBlock):
        widths.append(("hidden width", module.intermediate["dense"].out_features))
    for what, n in widths:
        if n % T:
            raise ValueError(f"--mesh_model_parallel {T} does not divide the {n} {what} of "
                             f"{type(module).__name__} {name or '(root)'}")


def check_model_parallel(model: nn.Module, T: int) -> None:
    """Raise a ``ValueError`` naming the module unless T divides every
    sharded attention's heads and every sharded MLP's hidden width."""
    for name, module in model.named_modules():
        if isinstance(module, _tp_modules()):
            _check_divides(name, module, T)


@torch.no_grad()
def shard_module(model: nn.Module) -> nn.Module:
    """Slice ``model``'s matched weights (``tp_split``) in place to this
    rank's shard over its model group, set each sharded attention's local
    head count and mark the modules that run *f* and *g*; the state-dict
    keys stay as they are, each parameter stays the same object (marked
    ``tp_split``). Call it after the weights are loaded (every rank calls
    it: rank 0's full weights are broadcast first, ``broadcast_module``) and
    before the optimizer is built. Does nothing at T = 1; raises a
    ``ValueError`` (``check_model_parallel``) where T does not divide a
    width."""
    from act_tpu_torch.parallel.collectives import broadcast_module
    T, m = mesh.model_count(), mesh.model_index()
    if T == 1:
        return model
    if is_sharded(model):
        raise ValueError("the model is already sharded")
    check_model_parallel(model, T)
    broadcast_module(model)
    flagged = []
    for name, module in model.named_modules():
        if isinstance(module, _tp_modules()):
            module.model_parallel = T
            flagged.append(name + ".")
            if hasattr(module, "num_heads"):
                module.num_heads //= T
    for name, p in model.named_parameters():
        kind = tp_split(name)
        if kind is None:
            continue
        if not any(name.startswith(f) for f in flagged):
            raise ValueError(f"{name} matches a tensor-parallel rule outside the modules "
                             f"that run it")
        p.data = _shard(p.data, kind, T, m).clone()
        p.tp_split = kind
    model.model_parallel = T
    return model


def _split_params(model: nn.Module) -> Dict[str, str]:
    return {n: p.tp_split for n, p in model.named_parameters() if hasattr(p, "tp_split")}


def _gather(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Each tensor's T shards over the model group, in model-index order,
    on the host: one all-gather of every tensor's bytes."""
    T = mesh.model_count()
    if not tensors:
        return []
    raw = [t.detach().contiguous().cpu().reshape(-1).view(torch.uint8) for t in tensors]
    flat = torch.cat(raw)
    parts = [torch.empty_like(flat) for _ in range(T)]
    dist.all_gather(parts, flat, group=mesh.model_cpu_group())
    out, at = [], 0
    for t, r in zip(tensors, raw):
        n = r.numel()
        out.append([p[at:at + n].view(t.dtype).reshape(t.shape) for p in parts])
        at += n
    return out


def full_tensors(model: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` (tensors keyed by ``model``'s parameter names: its state
    dict, its gradients) with every shard of a sharded parameter gathered
    over the model group (every model peer calls it) and put back together,
    on the host."""
    out = dict(named)
    if not is_sharded(model):
        return out
    split = _split_params(model)
    keys = [k for k in out if k in split]
    for k, shards in zip(keys, _gather([out[k] for k in keys])):
        out[k] = _unshard(shards, split[k])
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the full, one-process layout
    (``full_tensors``); the unsharded model's own state dict as it is."""
    sd = model.state_dict()
    return full_tensors(model, sd) if is_sharded(model) else sd


def load_full_state_dict(model: nn.Module, sd, strict: bool = True):
    """Load a full-layout state dict into ``model``, each sharded tensor
    sliced to this rank's shard first (``model.load_state_dict``'s result)."""
    if is_sharded(model):
        T, m = mesh.model_count(), mesh.model_index()
        split = _split_params(model)
        sd = {k: _shard(v, split[k], T, m) if k in split else v for k, v in sd.items()}
    return model.load_state_dict(sd, strict=strict)


def _optimizer_params(optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _split_moments(state: Dict, params: List[torch.Tensor], full: bool):
    """A copy of the optimizer state dict ``state`` (the tensors shared, the
    containers new: ``optimizer.state_dict()`` hands out the live per-parameter
    dicts) and (container, key, param) of every tensor in it shaped as a
    sharded parameter's shard (``full``: as the whole parameter): the moments
    and momenta, and ``MultiSteps``'s accumulated gradients."""
    state = dict(state)
    inner = state
    if "inner" in state:
        inner = state["inner"] = dict(state["inner"])
        state["acc"] = list(state["acc"])
    inner["state"] = {i: dict(st) for i, st in inner["state"].items()}
    T, found = mesh.model_count(), []
    for i, st in inner["state"].items():
        p = params[int(i)]
        if hasattr(p, "tp_split"):
            shape = _full_shape(p.shape, p.tp_split, T) if full else p.shape
            found += [(st, k, p) for k, v in st.items() if torch.is_tensor(v) and v.shape == shape]
    if "acc" in state:
        found += [(state["acc"], i, p) for i, p in enumerate(params) if hasattr(p, "tp_split")]
    return state, found


def full_optimizer_state_dict(optimizer) -> Dict:
    """``optimizer.state_dict()`` with every sharded parameter's moments in
    the full layout (gathered as ``full_state_dict``); the optimizer's own
    state is left as it is."""
    params = _optimizer_params(optimizer)
    if not any(hasattr(p, "tp_split") for p in params):
        return optimizer.state_dict()
    state, found = _split_moments(optimizer.state_dict(), params, full=False)
    for (box, k, p), shards in zip(found, _gather([box[k] for box, k, _ in found])):
        box[k] = _unshard(shards, p.tp_split)
    return state


def load_full_optimizer_state_dict(optimizer, state: Dict) -> None:
    """Load a full-layout optimizer state, each sharded moment sliced to
    this rank's shard first."""
    params = _optimizer_params(optimizer)
    if any(hasattr(p, "tp_split") for p in params):
        state, found = _split_moments(state, params, full=True)
        T, m = mesh.model_count(), mesh.model_index()
        for box, k, p in found:
            box[k] = _shard(box[k], p.tp_split, T, m)
    optimizer.load_state_dict(state)


def clip_grad_norm_(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` by the norm of the whole gradient:
    the squared norms of the sharded gradients summed over the model group,
    the replicated ones (equal on the model peers) counted once. Without a
    sharded parameter, torch's own."""
    if not any(hasattr(p, "tp_split") for p in params):
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    held = [p for p in params if p.grad is not None]
    sq = [torch.linalg.vector_norm(p.grad, 2, dtype=torch.float32) ** 2 for p in held]
    split = torch.stack([s for s, p in zip(sq, held) if hasattr(p, "tp_split")]).sum()
    dist.all_reduce(split, group=mesh.model_group())
    rest = [s for s, p in zip(sq, held) if not hasattr(p, "tp_split")]
    total = (split + torch.stack(rest).sum() if rest else split).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_([p.grad for p in held], coef)
    return total
