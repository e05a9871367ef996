"""The port's Stage-II train step and entry point held against the JAX package.

One f32 train step of the small distillation model (drop path 0, prompt
dropout neutralised on both sides) on the same parameters and batch as
``make_pretrain_step``, with the mask and the Gumbel draws pinned from an
``apply`` under the step's own rngs. Tolerances:

- loss and BatchNorm running statistics: atol 1e-5 (f32, sum order only);
- gradients: within 1e-4 of each tensor's largest gradient, except where the
  JAX gradient is zero up to rounding (below 1e-6 of the largest gradient
  anywhere): the student encoder's conv2 bias only shifts conv3's input
  before a BatchNorm, whose mean subtraction cancels it;
- parameter deltas after the AdamW step: within 2 f32 ulp of the parameter
  plus 1e-3 of the delta, against optax's first step
  ``-lr * (g / (|g| + 1e-8) + 0.05 p)`` (decay where it applies) from the
  port's own gradient, and against the JAX step's delta wherever
  |g| >= 1e-6: below that Adam's normalised step turns rounding-level
  gradient differences into different steps (up to a full step of either
  sign for a gradient that is zero up to rounding). The unused ``cls_head``
  gets zero gradients on both sides, so its kernels take the decay alone.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from act_tpu.datasets.synthetic import synthetic_cloud as jax_synthetic_cloud
from act_tpu.engine import builder as jbuilder
from act_tpu.engine import torch_convert as tc
from act_tpu.engine.checkpoint import flatten_keys
from act_tpu.engine.train_state import TrainState, make_pretrain_step
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.models import ACT_PointDistillation as JDistill
from act_tpu.models import common as jcommon

from act_tpu_torch import ops
from act_tpu_torch.datasets import scale_and_translate, synthetic_batch, synthetic_cloud
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine.runner_pretrain import run_steps
from act_tpu_torch.engine.train_state import STREAMS, pretrain_step, step_rngs
from act_tpu_torch.models import ACT_PointDistillation, act, common
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_stage2 import jax_variables

ATOL = 1e-5


def train_cfg(npoints=128, bs=4, drop_path=0.1):
    model = graft._pretrain_cfg(tiny=True)
    model.transformer_config.drop_path_rate = drop_path
    return ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=1e-3, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        dataset=dict(train=dict(others=dict(npoints=npoints))), total_bs=bs,
        model=dict(model)))


def flat_np(tree):
    return flatten_keys(jax.tree_util.tree_map(np.asarray, tree))


def to_flax(sd):
    """A port-keyed dict -> (flat flax params, flat flax batch stats)."""
    p, bs = tc.convert_state_dict({k: np.asarray(x) for k, x in sd.items()},
                                  tc.act_distillation_rules())
    return flatten_keys(p), flatten_keys(bs)


def test_one_train_step_matches_make_pretrain_step(rng, monkeypatch):
    monkeypatch.setattr(jcommon.FastDropout, "__call__",
                        lambda self, x, deterministic=True: x)
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    cfg = train_cfg(drop_path=0.0)
    jm = JDistill(cfg.model)
    pts = rng.normal(size=(4, 128, 3)).astype(np.float32)
    v = jax_variables(jm, rng, pts)
    params, stats = v["params"], v["batch_stats"]

    # JAX: pin the step's draws, its gradients, and the step itself
    base = jax.random.PRNGKey(7)
    rngs = jax_step_rngs(base, jnp.int32(0))
    rngs.pop("augment")
    (j_loss, inter), j_grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p, "batch_stats": stats}, jnp.asarray(pts), train=True, rngs=rngs,
        mutable=["batch_stats", "intermediates"]), has_aux=True))(params)
    inter = inter["intermediates"]
    mask = torch.from_numpy(np.array(inter["mask"][0]))
    u = torch.from_numpy(np.array(inter["dvae_tokenizer"]["gumbel_u"][0]))
    trainable = jbuilder.freeze_mask_from_paths(params, ["dvae_tokenizer"])
    tx, _ = jbuilder.build_optimizer(cfg, params, 4, trainable)
    step = make_pretrain_step(jm, transform_fn=None, trainable_mask=trainable)
    j_state, metrics = step(TrainState.create(v, tx), jnp.asarray(pts), base)
    assert float(metrics["loss"]) == float(j_loss)

    # port: the same parameters, draws pinned to JAX's
    model = ACT_PointDistillation(cfg.model)
    model.load_state_dict(weights.distillation_state_dict(params, stats), strict=True)
    builder.freeze(model, ["dvae_tokenizer"])
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    monkeypatch.setattr(act, "random_mask", lambda g, B, G, n: mask)
    monkeypatch.setattr(ops, "gumbel_argmax", lambda logits, seed: torch.argmax(
        logits - torch.log(-torch.log(u)), dim=-1))
    before = {k: x.clone() for k, x in model.state_dict().items()}
    gens = {name: torch.Generator() for name in STREAMS}
    loss = pretrain_step(model, opt, schedule, torch.from_numpy(pts), 0, gens, transform=None)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=ATOL)

    # gradients
    got_g, _ = to_flax({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    want_g = flat_np(j_grads)
    want_g = {k: g for k, g in want_g.items() if not k.startswith("dvae_tokenizer")}
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    unused = {k for k in want_g if ".cls_head." in k}
    for k in unused:  # exactly zero on both sides
        assert not want_g[k].any() and not got_g[k].any(), k
    noise = {k for k, g in want_g.items()
             if k not in unused and np.abs(g).max() < 1e-6 * g_max}
    assert noise == {"ACT_encoder.encoder.conv2.bias"}
    for k, g in got_g.items():
        if k not in noise:
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)

    # parameter deltas, BN statistics, the frozen tokenizer
    after = model.state_dict()
    lr = schedule(0)
    assert math.isclose(lr, 1e-6, rel_tol=1e-9)
    deltas, _ = to_flax({k: after[k] - before[k] for k in after
                         if after[k].is_floating_point() and not k.startswith("dvae_tokenizer")})
    old_p, new_p = flat_np(params), flat_np(j_state.params)
    for k, d in deltas.items():
        if k not in want_g:
            continue  # running statistics
        p, g = old_p[k].astype(np.float64), got_g[k].astype(np.float64)
        decay = p.ndim > 1 and "bias" not in k and "token" not in k
        first_step = -lr * (g / (np.abs(g) + 1e-8) + (0.05 * p if decay else 0.0))
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        assert (np.abs(d - first_step) <= ulp + 1e-3 * np.abs(first_step)).all(), k
        want_d = new_p[k] - old_p[k]
        sure = np.abs(want_g[k]) >= 1e-6  # a step that no gradient rounding can flip
        assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
    assert not deltas["ACT_encoder.cls_head.layers_0.bias"].any()
    _, got_bs = to_flax({k: x for k, x in after.items() if "running" in k})
    want_bs = flat_np(j_state.batch_stats)
    assert sorted(got_bs) == sorted(want_bs)
    for k, x in got_bs.items():
        np.testing.assert_allclose(x, want_bs[k], rtol=0, atol=ATOL, err_msg=k)
        assert not np.array_equal(x, flat_np(stats)[k]), k
    for k, x in after.items():
        if k.startswith("dvae_tokenizer.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(x, before[k]), k


def test_cos_lr_matches_optax():
    cfg = train_cfg()
    want = jbuilder.build_schedule(cfg.scheduler, cfg.optimizer.kwargs, 4)
    got = builder.build_schedule(cfg, 4)
    # optax evaluates in f32: (1e-6 - 1e-3) * frac + 1e-3 rounds at ulp(1e-3) = 1.2e-10
    for step in (0, 1, 39, 40, 41, 620, 1199, 1200, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=2e-10,
                                   err_msg=str(step))
    assert math.isclose(got(0), 1e-6, rel_tol=1e-9)


def test_decay_rule_freeze_and_frozen_bf16():
    model = ACT_PointDistillation(train_cfg().model)
    assert builder.decays("ACT_encoder.blocks.blocks.0.attn.qkv.weight",
                          model.ACT_encoder.blocks.blocks[0].attn.qkv.weight)
    for name in ("mask_token", "ACT_encoder.cls_token", "ACT_encoder.norm.weight",
                 "proj_head.bias"):
        assert not builder.decays(name, model.get_parameter(name))
    assert builder.decays("ACT_encoder.cls_pos", model.ACT_encoder.cls_pos)
    builder.freeze(model, ["dvae_tokenizer"])
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert all(n.startswith("dvae_tokenizer.") or n.endswith("_conv.0.bias") for n in frozen)
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if n.startswith("dvae_tokenizer."))
    builder.cast_frozen_bf16(model, ["dvae_tokenizer"])
    dt = {n: p.dtype for n, p in model.named_parameters()}
    assert dt["dvae_tokenizer.codebook"] == torch.bfloat16
    assert dt["dvae_tokenizer.visual_embed.0.0.attn.qkv.weight"] == torch.bfloat16
    assert dt["dvae_tokenizer.deep_prompt_tokens"] == torch.bfloat16
    assert dt["dvae_tokenizer.visual_embed.0.0.attn.qkv.bias"] == torch.float32
    assert dt["dvae_tokenizer.dgcnn_1.layer1.1.weight"] == torch.float32
    assert dt["ACT_encoder.blocks.blocks.0.attn.qkv.weight"] == torch.float32
    opt, _ = builder.build_optimizer(train_cfg(), model, 4)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert all((id(p) in in_opt) == p.requires_grad for p in model.parameters())
    assert opt.param_groups[0]["weight_decay"] == 0.05
    assert opt.param_groups[1]["weight_decay"] == 0.0


def test_run_steps_on_cpu():
    """The entry point on the tiny model: finite losses, the tokenizer's
    parameters bit for bit unchanged, its BatchNorm statistics and the
    student's parameters moved."""
    cfg = train_cfg()
    run = run_steps(cfg, 2, device="cpu")
    assert len(run.losses) == 2 and all(math.isfinite(x) for x in run.losses)
    assert len(run.step_ms) == 2
    ref = run_steps(cfg, 0, device="cpu").model.state_dict()
    after = run.model.state_dict()
    for k, x in after.items():
        if k.startswith("dvae_tokenizer.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(x, ref[k]), k
    assert not torch.equal(after["dvae_tokenizer.encoder.first_conv.1.running_mean"],
                           ref["dvae_tokenizer.encoder.first_conv.1.running_mean"])
    assert not torch.equal(after["ACT_encoder.norm.weight"], ref["ACT_encoder.norm.weight"])
    again = run_steps(cfg, 2, device="cpu", batches=[synthetic_batch(i, 4, 128) for i in range(2)])
    assert again.losses == run.losses


def test_run_steps_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_steps(train_cfg(), 1)


def test_synthetic_clouds_match_jax():
    for i in (0, 1, 2, 3, 77):
        np.testing.assert_array_equal(synthetic_cloud(i, 256)[0], jax_synthetic_cloud(i, 256)[0])
    batch = synthetic_batch(1, 4, 64)
    np.testing.assert_array_equal(batch[2], synthetic_cloud(6, 64)[0])


def test_step_rngs_and_augment():
    a, b = step_rngs(0, 3, "cpu"), step_rngs(0, 3, "cpu")
    assert sorted(a) == sorted(STREAMS)
    assert torch.equal(torch.rand(4, generator=a["mask"]), torch.rand(4, generator=b["mask"]))
    c = step_rngs(0, 4, "cpu")
    assert not torch.equal(torch.rand(4, generator=a["gumbel"]), torch.rand(4, generator=c["gumbel"]))
    pc = torch.ones(64, 10, 3)
    out = scale_and_translate(pc, torch.Generator().manual_seed(0))
    assert float(out.min()) >= 2 / 3 - 0.2 - 1e-6 and float(out.max()) <= 1.5 + 0.2 + 1e-6
    assert torch.equal(out[:, 0], out[:, 9])  # one scale and shift a cloud
