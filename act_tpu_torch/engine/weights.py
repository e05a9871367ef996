"""Weight bridge: JAX (flax) parameters, given as numpy arrays, to port state dicts.

Inverts the torch -> flax rules of ``act_tpu/engine/torch_convert.py``
(``student_rules``, ``point_transformer_rules``, ``dvae_rules``,
``act_distillation_rules``, ``seg_rules`` and ``act_pointbert_rules`` with
``pointbert_buffers``, :346-525), so the port's
modules, which keep the reference PyTorch key layout, run the same weights as
the JAX package:

- dense kernels (in, out) are transposed to (out, in); the conv keys get a
  trailing 1, (out, in, 1);
- flax ``scale`` becomes ``weight``; BatchNorm ``batch_stats`` mean/var become
  ``running_mean``/``running_var``;
- the conv biases that the JAX side folded into the BatchNorm means
  (``fold_encoder_conv_bias``, torch_convert.py:60-85: the group encoder's
  conv1/conv3, the FoldingNet's final_conv.0/.3) come back as zeros.

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


def blocks_state(p: Mapping, prefix: str) -> StateDict:
    """A stack's blocks (``blocks_N`` subtrees or one scanned ``blocks``) ->
    ``{prefix}.N.*``."""
    sd: StateDict = {}
    for name, blk in unstack_blocks(p).items():
        if name.startswith("blocks_"):
            sd.update(block_state(blk, f"{prefix}.{name.split('_')[1]}"))
    return sd


def dgcnn_state(p: Mapping, prefix: str) -> StateDict:
    """DGCNN input_trans (Conv1d), layer1-4 (Conv2d + GroupNorm) and layer5
    (Conv1d + GroupNorm) in the reference layout (``torch_convert.py:109-117``)."""
    sd = dense_state(p["input_trans"], _key(prefix, "input_trans"), conv=True)
    for i in range(1, 6):
        w = np.asarray(p[f"layer{i}"]["conv"]["kernel"]).T
        sd[_key(prefix, f"layer{i}.0.weight")] = _t(
            w[:, :, None] if i == 5 else w[:, :, None, None])
        sd.update(norm_state(p[f"layer{i}"]["gn"], _key(prefix, f"layer{i}.1")))
    return sd


def teacher_state(p: Mapping, prefix: str) -> StateDict:
    """A ViT PromptedTeacher's params (flax ``visual_embed``) -> the
    reference's sibling keys of the tokenizer (``torch_convert.py:197-215,
    328-343``)."""
    sd = {**dense_state(p["proj_pre"], _key(prefix, "proj_pre")),
          **dense_state(p["proj_post"], _key(prefix, "proj_post")),
          **dense_state(p["pos_fc1"], _key(prefix, "visual_pos_embed.0")),
          **dense_state(p["pos_fc2"], _key(prefix, "visual_pos_embed.2")),
          **norm_state(p["norm"], _key(prefix, "visual_embed.1"))}
    for name in ("visual_prompt_token", "visual_prompt_pos", "deep_prompt_tokens",
                 "deep_prompt_pos"):
        if name in p:
            sd[_key(prefix, name)] = _t(p[name])
    sd.update(blocks_state(p, _key(prefix, "visual_embed.0")))
    return sd


def tokenizer_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """A dVAE's params but the FoldingNet decoder (all of Stage II's
    tokenizer). ``dgcnn_2``, the codebook and the teacher only where the
    tree has them: flax creates no parameters for a submodule that never
    runs, and ACT_PointBERT runs only the encoder and ``dgcnn_1``."""
    sd = {**encoder_state(p["encoder"], stats["encoder"], _key(prefix, "encoder")),
          **dgcnn_state(p["dgcnn_1"], _key(prefix, "dgcnn_1"))}
    if "dgcnn_2" in p:
        sd.update(dgcnn_state(p["dgcnn_2"], _key(prefix, "dgcnn_2")))
    if "codebook" in p:
        sd[_key(prefix, "codebook")] = _t(p["codebook"])
    if "visual_embed" in p:
        sd.update(teacher_state(p["visual_embed"], prefix))
    return sd


def folding_decoder_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """FoldingDecoder mlp1-3, final1/fbn1/final2/fbn2/final3 -> ``mlp.0/2/4``
    and ``final_conv.0/1/3/4/6`` (``torch_convert.py:148-165``); the
    final_conv.0/.3 biases are exported as zeros."""
    return {
        **dense_state(p["mlp1"], _key(prefix, "mlp.0")),
        **dense_state(p["mlp2"], _key(prefix, "mlp.2")),
        **dense_state(p["mlp3"], _key(prefix, "mlp.4")),
        **dense_state(p["final1"], _key(prefix, "final_conv.0"), conv=True, zero_bias=True),
        **bn_state(p["fbn1"], stats["fbn1"], _key(prefix, "final_conv.1")),
        **dense_state(p["final2"], _key(prefix, "final_conv.3"), conv=True, zero_bias=True),
        **bn_state(p["fbn2"], stats["fbn2"], _key(prefix, "final_conv.4")),
        **dense_state(p["final3"], _key(prefix, "final_conv.6"), conv=True),
    }


def dvae_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """A JAX Stage-I dVAE's (params, batch_stats) (``DiscreteVAE`` or the
    ViT-prompted one) -> the port's state dict, the inverse of
    ``torch_convert.dvae_rules`` (``torch_convert.py:346``)."""
    sd = tokenizer_state(params, batch_stats, "")
    sd.update(folding_decoder_state(params["decoder"], batch_stats["decoder"], "decoder"))
    return sd


def student_state(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """VisableOnlyMaskTransformer's params (``torch_convert.py:369-393``)."""
    sd = encoder_state(p["encoder"], stats["encoder"], _key(prefix, "encoder"))
    if "reduce_dim" in p:
        sd.update(dense_state(p["reduce_dim"], _key(prefix, "reduce_dim")))
    sd[_key(prefix, "cls_token")] = _t(p["cls_token"])
    sd[_key(prefix, "cls_pos")] = _t(p["cls_pos"])
    sd.update(pos_embed_state(p["pos_embed"], _key(prefix, "pos_embed")))
    sd.update(blocks_state(p["blocks"], _key(prefix, "blocks.blocks")))
    sd.update(norm_state(p["norm"], _key(prefix, "norm")))
    sd.update(dense_state(p["cls_head"]["layers_0"], _key(prefix, "cls_head.0")))
    sd.update(dense_state(p["cls_head"]["layers_2"], _key(prefix, "cls_head.2")))
    return sd


def distillation_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """A JAX ACT_PointDistillation's (params, batch_stats) -> the port's
    state dict, the inverse of ``torch_convert.act_distillation_rules``
    (``torch_convert.py:346-443``); unrolled or scanned stacks."""
    bs = batch_stats
    sd = student_state(params["ACT_encoder"], bs["ACT_encoder"], "ACT_encoder")
    sd.update(tokenizer_state(params["dvae_tokenizer"], bs["dvae_tokenizer"],
                              "dvae_tokenizer"))
    if "proj_head" in params:
        sd.update(dense_state(params["proj_head"], "proj_head"))
    if "mask_token" in params:
        sd["mask_token"] = _t(params["mask_token"])
        sd.update(pos_embed_state(params["decoder_pos_embed"], "decoder_pos_embed"))
        sd.update(blocks_state(params["ACT_decoder"], "ACT_decoder.blocks"))
        sd.update(norm_state(params["ACT_decoder"]["norm"], "ACT_decoder.norm"))
    if "cls_pos" in params:
        sd["cls_pos"] = _t(params["cls_pos"])
    return sd


def pointbert_state_dict(params: Mapping, batch_stats: Mapping,
                         buffers: Optional[Mapping] = None) -> StateDict:
    """A JAX ACT_PointBERT's (params, batch_stats, buffers) -> the port's
    state dict, the inverse of ``torch_convert.act_pointbert_rules`` and
    ``pointbert_buffers`` (``torch_convert.py:497-525``); unrolled or scanned
    stacks. The q/k trunks are ``student_state`` plus ``mask_token`` and
    ``lm_head``; the tokenizer (``dvae.``) holds what the tree has, in JAX its
    encoder and dgcnn_1 alone. ``queue`` comes out (cls_dim, K) f32 and
    ``queue_ptr`` (1,) int64, the reference's buffer layout."""
    sd: StateDict = {}
    for name in ("transformer_q", "transformer_k"):
        p = params[name]
        sd.update(student_state(p, batch_stats[name], name))
        sd[f"{name}.mask_token"] = _t(p["mask_token"])
        sd.update(dense_state(p["lm_head"], f"{name}.lm_head"))
    sd.update(tokenizer_state(params["dvae"], batch_stats["dvae"], "dvae"))
    if buffers:
        sd["queue"] = _t(buffers["queue"])
        sd["queue_ptr"] = torch.tensor(np.asarray(buffers["queue_ptr"]).reshape(1),
                                       dtype=torch.long)
    return sd


def seg_state_dict(params: Mapping, batch_stats: Mapping, with_label: bool) -> StateDict:
    """A JAX ``PartSegTransformer`` (``with_label``) or ``SemSegTransformer``'s
    (params, batch_stats) -> the port's state dict, the inverse of
    ``torch_convert.seg_rules`` (``torch_convert.py:444-494``); unrolled or
    scanned stacks."""
    bb, hd = params["backbone"], params["head"]
    bbs, hds = batch_stats["backbone"], batch_stats["head"]
    sd = encoder_state(bb["encoder"], bbs["encoder"], "encoder")
    sd.update(pos_embed_state(bb["pos_embed"], "pos_embed"))
    sd.update(blocks_state(bb["blocks"], "blocks.blocks"))
    sd.update(norm_state(bb["norm"], "norm"))
    prop, prop_s = hd["propagation_0"], hds["propagation_0"]
    for i in (0, 1):
        sd.update(dense_state(prop[f"conv{i}"], f"propagation_0.mlp_convs.{i}", conv=True))
        sd.update(bn_state(prop[f"bn{i}"], prop_s[f"bn{i}"], f"propagation_0.mlp_bns.{i}"))
    for j in (1, 2, 3):
        sd.update(dense_state(hd[f"convs{j}"], f"convs{j}", conv=True))
    for j in (1, 2):
        sd.update(bn_state(hd[f"bns{j}"], hds[f"bns{j}"], f"bns{j}"))
    if with_label:
        sd.update(dense_state(hd["label_conv"], "label_conv.0", conv=True))
        sd.update(bn_state(hd["label_bn"], hds["label_bn"], "label_conv.1"))
    return sd


SEG_HEAD_KEYS = ("propagation_0", "convs1", "convs2", "convs3", "bns1", "bns2", "label_conv")


def seg_reference_keys(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A segmentation state dict with the reference's ``_cls`` head keys
    (``propagation_0_cls.*``, ``convs1_cls.*``, ``label_conv_cls.*``, the
    layout of the current reference code) renamed to the released
    checkpoints' keys that the port uses, as the reference's
    ``load_model_from_ckpt_withrename`` maps between them
    (semantic_segmentation/models/pt.py:280-300). Other keys pass through."""
    out = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head.endswith("_cls") and head[:-4] in SEG_HEAD_KEYS:
            k = f"{head[:-4]}.{rest}"
        out[k] = v
    return out
