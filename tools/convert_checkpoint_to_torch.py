"""Convert a JAX package's orbax checkpoint to the PyTorch port's ``.pth``.

The inverse of ``tools/convert_checkpoint.py``: a run trained with
``act_tpu`` moves to ``act_tpu_torch`` and is finetuned or resumed there.

    python tools/convert_checkpoint_to_torch.py --config <yaml> \\
        --src work_dirs/<exp>/ckpt-last --dst <exp dir>/ckpt-last.pth [--weights_only]
    python tools/convert_checkpoint_to_torch.py --model PartSegTransformer \\
        --src work_dirs/part_seg/<exp>/ckpt-best --dst part_seg.pth

``--config`` is the YAML the JAX run trained (finetune, Stage I or Stage II);
the segmentation models, which their CLIs build from flags, take ``--model``
with those CLIs' defaults (``--num_group`` 128). The script imports JAX and
orbax to read the file, so it runs where JAX is installed, never on the
card's machine; the port imports neither it nor ``act_tpu``.

What it does, as ``act_tpu/engine/checkpoint.py`` ``resume_state`` would:

- builds the JAX model's trees (``jax.eval_shape`` of ``init``, nothing is
  computed) and its optax transformation from the config, as the JAX runners
  do, restores the orbax tree (``load_checkpoint``) and rebuilds the optax
  containers (``restructure_like``); a file of another layout (per-block
  stacks, the conv biases before the fold) is migrated by
  ``adapt_block_layout`` and ``fold_legacy_encoder_bias``, its optimizer
  moments dropped with a printed line;
- maps params, BatchNorm statistics and buffers to the port's state dict by
  ``model.NAME`` (``act_tpu_torch/engine/weights.py``) and loads it into the
  port's model of the same config with ``strict=True`` (a missing or extra
  key raises and names it), then freezes and casts as the port's trainer does;
- maps the optimizer state by parameter name through the same functions
  (every mapping is linear): optax ``ScaleByAdamState`` -> AdamW/Adam
  ``step``, ``exp_avg``, ``exp_avg_sq``; ``TraceState`` -> SGD
  ``momentum_buffer``; ``MultiStepsState`` -> the port's ``MultiSteps``
  (``mini_step``, ``updates``, the accumulated gradients). Frozen leaves
  (``set_to_zero``) get no state;
- carries ``step``, ``epoch``, ``metrics``, ``best_metrics`` and a mid-epoch
  cursor ``{'next_batch': k}`` (as the port's ``{'epoch': e, 'next_batch':
  k}``; no dataset draws: the JAX package restarts them), and checks that
  optax's update count is the port's schedule index.

The output is the port's checkpoint ``{base_model, optimizer, step, epoch,
metrics, best_metrics[, data_iter]}`` (``act_tpu_torch/engine/checkpoint.py``
``save_checkpoint``): ``--resume`` reads it as ``ckpt-last.pth``, and
``--ckpts``, ``--start_ckpts``, ``dvae_config.ckpt`` and ``main_tsne`` read
its weights. ``--weights_only`` writes ``{base_model}`` alone.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SEG_MODELS = {"PartSegTransformer": ("partseg", 50), "SemSegTransformer": ("semseg", 13)}
PRETRAIN_MODELS = ("ACT_PointDistillation", "ACT_PointBERT")
# ACT_PointBERT's tokenizer runs only its encoder, dgcnn_1 and codebook, so the
# JAX package never creates these of its parts; the port's model has them, and
# they take the port's seeded init (tests/test_torch_port_pointbert.py JAX_NEVER)
POINTBERT_NEVER = ("dvae.dgcnn_2.", "dvae.visual_embed.", "dvae.proj_pre.", "dvae.proj_post.",
                   "dvae.visual_pos_embed.", "dvae.visual_prompt_token",
                   "dvae.visual_prompt_pos", "dvae.deep_prompt_tokens", "dvae.deep_prompt_pos")
DVAE_MODELS = ("DiscreteVAE", "ACTPromptedDiscreteVAEwithVIT", "ACTPromptedDiscreteVAEwithBERT")
# the segmentation CLIs' defaults (part_segmentation/main.py, semantic_segmentation/main.py)
SEG_DEFAULTS = dict(num_group=128, npoint=2048, weight_decay=5e-2)


def load_configs(config: Optional[str], model: Optional[str], way: int = -1,
                 num_group: int = SEG_DEFAULTS["num_group"]):
    """The (JAX, port) configs of ``config`` (a YAML path) or of the
    segmentation ``model``; a few-shot config's ``cls_dim`` set to ``way``."""
    from act_tpu.utils.config import ConfigDict as JConfigDict
    from act_tpu.utils.config import cfg_from_yaml_file
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.utils.config import ConfigDict
    if model is not None:
        if model not in SEG_MODELS:
            raise ValueError(f"--model takes {sorted(SEG_MODELS)}; other models take --config")
        spec = dict(model=dict(NAME=model, cls_dim=SEG_MODELS[model][1],
                               num_group=int(num_group), group_size=32))
        return JConfigDict(spec), ConfigDict(spec)
    jcfg, cfg = cfg_from_yaml_file(config), load_config(config)
    if int(cfg.model.get("cls_dim", 1) or 0) <= 0:
        if way <= 0:
            raise ValueError(f"{config}: model.cls_dim is unset (a few-shot config); give --way")
        jcfg.model.cls_dim = cfg.model.cls_dim = int(way)
    return jcfg, cfg


def _npoints(cfg) -> int:
    if "npoints" in cfg:
        return int(cfg.npoints)
    return int(cfg.dataset.train.others.get("npoints", 1024))


def jax_targets(jcfg):
    """The JAX runner's trees for ``jcfg``: (params, batch_stats) as shapes
    and the optax state of its transformation (``jax.eval_shape``: nothing
    is computed), as ``runner_finetune.build_state``, ``runner_pretrain``,
    ``runner_autoencoder`` and ``runner_segmentation._make_state`` build them."""
    import jax
    import jax.numpy as jnp
    import optax
    from act_tpu.engine import builder
    from act_tpu.models import MODELS
    from act_tpu.models.point_transformer import trainable_mask

    name = str(jcfg.model.NAME)
    model = MODELS.build(jcfg.model)
    key = jax.random.PRNGKey(0)
    rngs = dict(params=key, gumbel=key, mask=key, dropout=key, droppath=key)
    if name in SEG_MODELS:
        n = SEG_DEFAULTS["npoint"]
        inputs = (jnp.zeros((1, n, 3), jnp.float32),)
        if name == "PartSegTransformer":
            inputs += (jnp.zeros((1, 16), jnp.float32),)
    else:
        inputs = (jnp.zeros((2, _npoints(jcfg), 3), jnp.float32),)
    variables = jax.eval_shape(lambda: model.init(rngs, *inputs))
    params = variables["params"]
    trainable = None
    if name == "PointTransformer":
        transfer = jcfg.model.get("transfer_type", "full")
        trainable = None if transfer == "full" else trainable_mask(params, transfer)
    elif name in PRETRAIN_MODELS:
        frozen = ["dvae", "transformer_k"] if name == "ACT_PointBERT" else ["dvae_tokenizer"]
        trainable = builder.freeze_mask_from_paths(params, frozen)
    elif name in DVAE_MODELS and jcfg.model.get("freeze_visual_embed", False):
        trainable = builder.freeze_mask_from_paths(
            params, [f"visual_embed']['blocks_", "visual_embed']['norm"])
    if name in SEG_MODELS:
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(1e-3, weight_decay=SEG_DEFAULTS["weight_decay"]))
    else:
        tx, _ = builder.build_optimizer(jcfg, params, 1, trainable)
    opt_state = jax.eval_shape(tx.init, params)
    return params, variables.get("batch_stats", {}), opt_state


def _plain(tree):
    """A restored or shape tree with its flax containers as dicts."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _key_diff(want, got) -> str:
    from act_tpu.engine.checkpoint import flatten_keys
    w, g = set(flatten_keys(want)), set(flatten_keys(got))
    return f"missing {sorted(w - g)[:5]}, unexpected {sorted(g - w)[:5]}"


def restore(src: str, params_t, stats_t, opt_t):
    """The orbax file at ``src`` as (payload, params, batch_stats, opt_state
    or None), migrated as ``resume_state`` does (``checkpoint.py:145-205``):
    the optax containers rebuilt on the live tree, or, for a legacy layout,
    the weights adapted and the moments dropped (None) with a printed line."""
    import jax
    from act_tpu.engine import checkpoint as jckpt
    payload = jckpt.load_checkpoint(src)
    params, stats = _plain(payload["params"]), _plain(payload.get("batch_stats") or {})
    same = lambda a, b: jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    if not same(params, params_t):
        params = jckpt.adapt_block_layout(params, params_t)
        stats = jckpt.adapt_block_layout(stats, stats_t)
        params, stats = jckpt.fold_legacy_encoder_bias(params, stats)
        if not same(params, params_t):
            raise ValueError(f"{src}: its parameters are not those of the config's model "
                             f"({_key_diff(params_t, params)})")
        print("[BRIDGE] legacy checkpoint layout: converted its weights (stacks and folded "
              "conv biases) and REINITIALIZED the optimizer moments, as the JAX resume does",
              flush=True)
        return payload, params, stats, None
    if payload.get("opt_state") is None:
        return payload, params, stats, None
    try:
        opt = jckpt.restructure_like(opt_t, payload["opt_state"])
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{src}: its optimizer state is not that of the config's optimizer "
                         f"({e!r})") from e
    return payload, params, stats, opt


def state_dict_fn(name: str, arch: str):
    """(tree, batch_stats, buffers) -> the port's state dict for ``model.NAME``."""
    from act_tpu_torch.engine import weights
    if name == "PointTransformer":
        return lambda p, s, b: weights.flax_to_state_dict(p, s)
    if name == "ACT_PointDistillation":
        return lambda p, s, b: weights.distillation_state_dict(p, s, arch)
    if name == "ACT_PointBERT":
        return lambda p, s, b: weights.pointbert_state_dict(p, s, b, arch)
    if name in DVAE_MODELS:
        return lambda p, s, b: weights.dvae_state_dict(p, s, arch)
    if name in SEG_MODELS:
        return lambda p, s, b: weights.seg_state_dict(p, s, name == "PartSegTransformer")
    raise NotImplementedError(f"no weight mapping for model {name}")


def port_model(cfg, sd):
    """The port's model of ``cfg`` with ``sd`` loaded strictly, frozen and
    cast as its trainer does, and the trainer's optimizer over it (on the
    CPU)."""
    from act_tpu_torch.engine import builder, runner_autoencoder, runner_finetune
    from act_tpu_torch.engine import runner_pretrain, runner_segmentation
    name = str(cfg.model.NAME)
    if name == "PointTransformer":
        st = runner_finetune.build_state(cfg, 1, 0, "cpu")
        st.model.load_state_dict(sd, strict=True)
        return st.model, st.optimizer
    if name in SEG_MODELS:
        st = runner_segmentation.build_seg_state(
            SEG_MODELS[name][0], 1, weight_decay=SEG_DEFAULTS["weight_decay"],
            num_group=int(cfg.model.num_group), device="cpu")
        st.model.load_state_dict(sd, strict=True)
        return st.model, st.optimizer
    if name in PRETRAIN_MODELS:
        model = runner_pretrain.build_pretrain_model(cfg.model, 0)
        if name == "ACT_PointBERT":
            never = {k: v for k, v in model.state_dict().items()
                     if k not in sd and k.startswith(POINTBERT_NEVER)}
            if never:
                print(f"[BRIDGE] {len(never)} tensors of the tokenizer's parts that "
                      "ACT_PointBERT never runs (the JAX package creates none) keep the "
                      "port's seeded init", flush=True)
            sd = {**never, **sd}
        model.load_state_dict(sd, strict=True)
        model = runner_pretrain.freeze_tokenizer(model, cfg)
    else:
        model = runner_autoencoder.build_autoencoder_model(cfg.model, 0)
        model.load_state_dict(sd, strict=True)
        if getattr(model, "has_teacher", False) and bool(cfg.model.get("freeze_visual_embed",
                                                                       False)):
            builder.freeze_teacher_backbone(model, bool(cfg.model.get("frozen_bf16", True)))
    return model, builder.build_optimizer(cfg, model, 1)[0]


def teacher_arch(cfg) -> str:
    """The teacher arch of a dVAE config or of a pretrain config's tokenizer."""
    from act_tpu_torch.models.teacher import teacher_arch as arch_of
    node = cfg.model
    if str(node.NAME) in PRETRAIN_MODELS:
        node = node.get("dvae_config", node)
    if str(node.get("NAME", "")) == "ACTPromptedDiscreteVAEwithBERT":
        return "bert"
    return arch_of(node.get("visual_embed_type", "vit_base_patch16_224"))


def _find(tree, cls) -> list:
    """The nodes of type ``cls`` in an optax state."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _find(t, cls)]
    if isinstance(tree, Mapping):
        return [x for t in tree.values() for x in _find(t, cls)]
    return []


def _moments(tree, params, to_sd, stats, keep) -> Dict:
    """A params-shaped optax tree (``MaskedNode`` where a leaf is frozen) ->
    {port parameter name: tensor} for the names in ``keep``."""
    import jax
    import optax
    full = jax.tree_util.tree_map(
        lambda m, p: (np.zeros(p.shape, np.float32) if isinstance(m, optax.MaskedNode)
                      else np.asarray(m, np.float32)),
        tree, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    sd = to_sd(full, stats, None)
    return {k: v for k, v in sd.items() if k in keep}


def fill_optimizer(optimizer, model, opt_state, params, stats, to_sd, step: int) -> None:
    """Put the optax state ``opt_state`` into the port's ``optimizer`` by
    parameter name (module docstring); check optax's update count against
    the port's schedule index (``train_state._update``: the step, or the
    updates taken under ``MultiSteps``)."""
    import optax
    import torch
    from act_tpu_torch.engine.builder import MultiSteps
    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in inner.param_groups for p in g["params"]]
    keep = set(order)
    index = step
    if isinstance(optimizer, MultiSteps):
        (ms,) = _find(opt_state, optax.MultiStepsState)
        optimizer.mini_step, optimizer.updates = int(ms.mini_step), int(ms.gradient_step)
        acc = _moments(ms.acc_grads, params, to_sd, stats, keep)
        with torch.no_grad():
            for a, n in zip(optimizer.acc, order, strict=True):
                a.copy_(acc[n])
        index = optimizer.updates
    counts = {int(s.count) for s in _find(opt_state, optax.ScaleByScheduleState)}
    if counts and counts != {index}:
        raise ValueError(f"optax's update count {sorted(counts)} is not the port's schedule "
                         f"index {index} (the step, or the updates under step_per_update)")
    adam, trace = _find(opt_state, optax.ScaleByAdamState), _find(opt_state, optax.TraceState)
    p_of = {names[id(p)]: p for g in inner.param_groups for p in g["params"]}
    if adam:
        (s,) = adam
        mu = _moments(s.mu, params, to_sd, stats, keep)
        nu = _moments(s.nu, params, to_sd, stats, keep)
        for n in order:
            inner.state[p_of[n]] = {"step": torch.tensor(float(int(s.count))),
                                    "exp_avg": mu[n].clone(), "exp_avg_sq": nu[n].clone()}
    elif trace:
        (s,) = trace
        tr = _moments(s.trace, params, to_sd, stats, keep)
        for n in order:
            inner.state[p_of[n]] = {"momentum_buffer": tr[n].clone()}
    else:
        raise NotImplementedError("the optax state holds neither Adam moments nor a trace")


def convert(src: str, dst: str, config: Optional[str] = None, model: Optional[str] = None,
            weights_only: bool = False, way: int = -1,
            num_group: int = SEG_DEFAULTS["num_group"]) -> Dict:
    """Write the port's checkpoint of the orbax file ``src`` to ``dst`` and
    return its payload."""
    import torch
    jcfg, cfg = load_configs(config, model, way, num_group)
    name = str(cfg.model.NAME)
    params_t, stats_t, opt_t = jax_targets(jcfg)
    payload, params, stats, opt_state = restore(src, _plain(params_t), _plain(stats_t), opt_t)
    arch = "vit" if name in SEG_MODELS or name == "PointTransformer" else teacher_arch(cfg)
    to_sd = state_dict_fn(name, arch)
    buffers = _plain(payload.get("buffers") or {})
    net, optimizer = port_model(cfg, to_sd(params, stats, buffers))
    out = {"base_model": net.state_dict()}
    if not weights_only:
        step = int(payload.get("step", 0))
        if opt_state is not None:
            fill_optimizer(optimizer, net, opt_state, params, stats, to_sd, step)
        epoch = int(payload.get("epoch", 0))
        out.update(optimizer=optimizer.state_dict(), step=step, epoch=epoch,
                   metrics={k: float(v) for k, v in (payload.get("metrics") or {}).items()},
                   best_metrics={k: float(v)
                                 for k, v in (payload.get("best_metrics") or {}).items()})
        next_batch = int((payload.get("data_iter") or {}).get("next_batch", 0))
        if next_batch > 0:
            out["data_iter"] = {"epoch": epoch, "next_batch": next_batch}
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(out, dst)
    print(f"[BRIDGE] {src} ({name}) -> {dst}: {len(out['base_model'])} tensors"
          + ("" if weights_only else f", step {out['step']}, epoch {out['epoch']}"), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the JAX run's orbax checkpoint directory")
    ap.add_argument("--dst", required=True, help="the .pth to write")
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--config", help="the YAML the JAX run trained")
    which.add_argument("--model", choices=sorted(SEG_MODELS),
                       help="a segmentation model, built with its CLI's defaults")
    ap.add_argument("--weights_only", action="store_true", help="write {base_model} alone")
    ap.add_argument("--way", type=int, default=-1, help="cls_dim of a few-shot config")
    ap.add_argument("--num_group", type=int, default=SEG_DEFAULTS["num_group"],
                    help="groups of a segmentation model (its CLI's --num_group)")
    args = ap.parse_args(argv)
    convert(args.src, args.dst, args.config, args.model, args.weights_only, args.way,
            args.num_group)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    main()
