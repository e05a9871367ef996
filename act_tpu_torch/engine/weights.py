"""Weight bridge: JAX (flax) parameters, given as numpy arrays, to port state dicts.

Inverts the torch -> flax rules of ``act_tpu/engine/torch_convert.py``
(``student_rules`` and ``point_transformer_rules``, :369-424), so the port's
modules, which keep the reference PyTorch key layout, run the same weights as
the JAX package:

- dense kernels (in, out) are transposed to (out, in); the conv keys get a
  trailing 1, (out, in, 1);
- flax ``scale`` becomes ``weight``; BatchNorm ``batch_stats`` mean/var become
  ``running_mean``/``running_var``;
- the conv1/conv3 biases that the JAX side folded into the BatchNorm means
  (``fold_encoder_conv_bias``, torch_convert.py:60-85) come back as zeros.

Both transformer-stack layouts are taken: per-block ``blocks_N`` subtrees and
the scanned ``blocks`` subtree whose leaves carry a leading depth axis (see
``act_tpu/engine/checkpoint.py`` ``adapt_block_layout``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def dense_state(p: Mapping, prefix: str, conv: bool = False,
                zero_bias: bool = False) -> StateDict:
    """flax Dense {kernel (in, out), bias?} -> {weight (out, in[, 1]), bias}."""
    w = np.asarray(p["kernel"]).T
    sd = {_key(prefix, "weight"): _t(w[:, :, None] if conv else w)}
    if "bias" in p:
        sd[_key(prefix, "bias")] = _t(p["bias"])
    elif zero_bias:
        sd[_key(prefix, "bias")] = torch.zeros(w.shape[0])
    return sd


def norm_state(p: Mapping, prefix: str) -> StateDict:
    """flax LayerNorm / BatchNorm params {scale, bias} -> {weight, bias}."""
    return {_key(prefix, "weight"): _t(p["scale"]), _key(prefix, "bias"): _t(p["bias"])}


def bn_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    sd = norm_state(p, prefix)
    sd[_key(prefix, "running_mean")] = _t(stats["mean"])
    sd[_key(prefix, "running_var")] = _t(stats["var"])
    sd[_key(prefix, "num_batches_tracked")] = torch.zeros((), dtype=torch.long)
    return sd


def mlp_state(p: Mapping, prefix: str) -> StateDict:
    return {**dense_state(p["fc1"], _key(prefix, "fc1")),
            **dense_state(p["fc2"], _key(prefix, "fc2"))}


def attention_state(p: Mapping, prefix: str) -> StateDict:
    return {**dense_state(p["qkv"], _key(prefix, "qkv")),
            **dense_state(p["proj"], _key(prefix, "proj"))}


def block_state(p: Mapping, prefix: str) -> StateDict:
    return {**norm_state(p["norm1"], _key(prefix, "norm1")),
            **attention_state(p["attn"], _key(prefix, "attn")),
            **norm_state(p["norm2"], _key(prefix, "norm2")),
            **mlp_state(p["mlp"], _key(prefix, "mlp"))}


def unstack_blocks(p: Mapping) -> Dict[str, Mapping]:
    """A TransformerEncoder's params -> {'blocks_N': block params}, from either
    layout (scanned: one 'blocks' subtree with a leading depth axis)."""
    if "blocks" not in p:
        return dict(p)

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    stacked = p["blocks"]
    leaf = stacked
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return {f"blocks_{i}": take(stacked, i) for i in range(np.asarray(leaf).shape[0])}


def encoder_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """GroupEncoder conv1/bn1/conv2/conv3/bn2/conv4 -> first_conv.0/1/3 and
    second_conv.0/1/3; conv1/conv3 biases are exported as zeros."""
    return {
        **dense_state(p["conv1"], _key(prefix, "first_conv.0"), conv=True, zero_bias=True),
        **bn_state(p["bn1"], stats["bn1"], _key(prefix, "first_conv.1")),
        **dense_state(p["conv2"], _key(prefix, "first_conv.3"), conv=True),
        **dense_state(p["conv3"], _key(prefix, "second_conv.0"), conv=True, zero_bias=True),
        **bn_state(p["bn2"], stats["bn2"], _key(prefix, "second_conv.1")),
        **dense_state(p["conv4"], _key(prefix, "second_conv.3"), conv=True),
    }


def pos_embed_state(p: Mapping, prefix: str) -> StateDict:
    return {**dense_state(p["fc1"], _key(prefix, "0")),
            **dense_state(p["fc2"], _key(prefix, "2"))}


def mlp3_head_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """Mlp3Head fc1/bn1/fc2/bn2/fc3 -> Sequential indices 0/1/4/5/8."""
    return {**dense_state(p["fc1"], _key(prefix, "0")),
            **bn_state(p["bn1"], stats["bn1"], _key(prefix, "1")),
            **dense_state(p["fc2"], _key(prefix, "4")),
            **bn_state(p["bn2"], stats["bn2"], _key(prefix, "5")),
            **dense_state(p["fc3"], _key(prefix, "8"))}


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> StateDict:
    """A JAX PointTransformer's (params, batch_stats) -> the port's state dict,
    in the reference PyTorch layout (loads with ``strict=True``)."""
    bs = batch_stats or {}
    sd: StateDict = {}
    sd.update(encoder_state(params["encoder"], bs["encoder"], "encoder"))
    if "reduce_dim" in params:
        sd.update(dense_state(params["reduce_dim"], "reduce_dim"))
    sd["cls_token"] = _t(params["cls_token"])
    sd["cls_pos"] = _t(params["cls_pos"])
    sd.update(pos_embed_state(params["pos_embed"], "pos_embed"))
    for name, blk in unstack_blocks(params["blocks"]).items():
        sd.update(block_state(blk, f"blocks.blocks.{name.split('_')[1]}"))
    sd.update(norm_state(params["norm"], "norm"))
    head = params["cls_head_finetune"]
    if "kernel" in head:  # linear head: Sequential(Linear)
        sd.update(dense_state(head, "cls_head_finetune.0"))
    else:
        sd.update(mlp3_head_state(head, bs["cls_head_finetune"], "cls_head_finetune"))
    if "side" in params:
        sd["side_alpha"] = _t(params["side_alpha"])
        sd.update(encoder_state(params["side"], bs["side"], "side"))
        sd.update(dense_state(params["side_projection"], "side_projection"))
    return sd
