"""The port's CLIP and BERT teachers held against the JAX package on the CPU.

The teacher 48 wide, 2 layers, 4 heads, 4 prompts, tokens 32, in a dVAE of
the JAX smoke widths (``test_torch_port_stage1.smoke_cfg``: G=16, M=8, 64
tokens). One JAX dVAE a teacher arch is drawn (in numpy, at the shapes of
its init), perturbed and carried over by the weight bridge (``weights.dvae_state_dict(..., arch)``); its teacher
subtree drives the stand-alone teacher tests. The Gumbel draws are pinned
by replaying the flax model's sown ``gumbel_u``. Inputs are numpy arrays
from a seed. Tolerances:

- f32 outputs and losses: atol 1e-5 (sum order only);
- bf16 teacher outputs: both packages round at the same places, but each
  rounding of a 1-ulp-different f32 value can land one bf16 ulp (2^-8
  relative) apart. The outputs reach ~3.4 in size, where a bf16 ulp is
  0.0156, and each side's bf16 output lies up to 0.031 from the f32 one
  (measured). So the port's bf16 output is held within atol 0.05 (3 ulps at
  the largest outputs) of JAX's, and within 1.5 times JAX's own bf16 error of
  JAX's f32 output: the port rounds no worse than the reference;
- the f32 Stage-I step: gradients within 1e-4 of each tensor's largest
  gradient, AdamW deltas within 2 f32 ulp of the parameter plus 1e-3 of the
  delta (``test_torch_port_stage1.py``'s rules). JAX's gradients are read
  from its step's first Adam moment (``mu = (1 - b1) g`` after one step
  from zero), so one jitted program gives both; its Gumbel uniforms
  (``act_tpu.models.dvae.fast_uniform``) are pinned to numpy draws that the
  port's step replays.
"""
import functools
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from act_tpu.engine import builder as jbuilder
from act_tpu.engine import torch_convert as tc
from act_tpu.engine.train_state import TrainState, make_autoencoder_step
from act_tpu.models import common as jcommon
from act_tpu.models import dvae as jdvae
from act_tpu.models.dvae import ACTPromptedDiscreteVAEwithBERT as JBert
from act_tpu.models.dvae import ACTPromptedDiscreteVAEwithVIT as JViT
from act_tpu.models.teacher import PromptedTeacher as JTeacher

from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import runner_autoencoder as runner
from act_tpu_torch.engine import runner_pretrain as rp
from act_tpu_torch.engine.train_state import STREAMS, autoencoder_step
from act_tpu_torch.models import (ACT_PointDistillation, ACTPromptedDiscreteVAEwithBERT,
                                  ACTPromptedDiscreteVAEwithVIT, PromptedTeacher, common)
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_stage1 import (VIT_CFG, jax_forward, jcfg, min_choice_gap,
                                          smoke_cfg)
from tests.test_torch_port_model import perturb
from tests.test_torch_port_stage2 import RNGS, close, japply, t, tiny_cfg
from tests.test_torch_port_train import flat_np

ATOL = 1e-5
BF16_ATOL = 0.05
BF16_ERR_RATIO = 1.5
ARCHS = ("clip", "bert")
DEPTH, WIDTH = 2, 48
# clouds on which no max-pool or Chamfer choice of the arch's step is near a
# tie (checked in the test, as in test_torch_port_stage1.py). A ReLU's kink
# at 0 is such a choice too, and too many to clear by a margin: about one
# seed in eight puts a ReLU or LeakyReLU input of one framework's f32 step on
# the other side of 0 than the other's, and the flipped mask moves gradients
# by 4e-3 to 0.16 of their scale (clip seed 18: the FoldingNet's final2 by
# 4e-3). These seeds show none; the gradient comparison would catch one
STEP_SEEDS = {"clip": 11, "bert": 2}


def arch_cfg(arch, num_group=16):
    """The smoke config with a CLIP teacher (``visual_embed_type:
    clip_ViT-B/16``) or as ``ACTPromptedDiscreteVAEwithBERT``."""
    cfg = smoke_cfg(VIT_CFG)
    cfg.grad_norm_clip = None
    cfg.model.num_group = num_group
    if arch == "clip":
        cfg.model.visual_embed_type = "clip_ViT-B/16"
    else:
        cfg.model.NAME = "ACTPromptedDiscreteVAEwithBERT"
    return cfg


def jax_class(arch):
    return JBert if arch == "bert" else JViT


def drawn_variables(module, rng, *inputs):
    """The module's variables drawn in numpy at the shapes of its init
    (``jax.eval_shape``: no init program to compile): kernels and the
    codebook at the init's scales (lecun-normal, N(0, 1)), prompts N(0,
    0.02^2), the rest as ``perturb`` draws them."""
    shapes = jax.eval_shape(lambda *xs: module.init(RNGS, *xs), *map(jnp.asarray, inputs))

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "codebook":
            return rng.normal(size=leaf.shape).astype(np.float32)
        return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
    return {k: perturb(jax.tree_util.tree_map_with_path(draw, x), rng) for k, x in shapes.items()}


@functools.lru_cache(maxsize=None)
def jax_dvae(arch):
    """(cfg, JAX module, drawn variables, the (2, 128, 3) input) of the
    arch's dVAE, drawn once for the whole file."""
    rng = np.random.default_rng(11 if arch == "clip" else 12)
    cfg = arch_cfg(arch)
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm = jax_class(arch)(jcfg(cfg).model)
    return cfg, jm, drawn_variables(jm, rng, pts), pts


def port_dvae(arch, cfg, v):
    cls = ACTPromptedDiscreteVAEwithBERT if arch == "bert" else ACTPromptedDiscreteVAEwithVIT
    model = cls(cfg.model)
    model.load_state_dict(weights.dvae_state_dict(v["params"], v["batch_stats"], arch),
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# the teacher alone, and the whole dVAE
# ---------------------------------------------------------------------------

def teacher_params(arch, deep):
    """The teacher subtree of the arch's JAX dVAE, without the deep prompts
    when ``deep`` is off."""
    p = dict(jax_dvae(arch)[2]["params"]["visual_embed"])
    if not deep:
        p.pop("deep_prompt_tokens"), p.pop("deep_prompt_pos")
    return p


_JAX_TEACHER = {}


def jax_teacher(arch, deep, dt, tok, center):
    """The JAX teacher's eval output at ``dt``, computed once a case."""
    key = (arch, deep, dt)
    if key not in _JAX_TEACHER:
        jm = JTeacher(embed_dim=WIDTH, depth=DEPTH, num_heads=4, tokens_dims=32,
                      num_prompt_token=4, use_deep_prompt=deep, arch=arch,
                      dtype=jnp.bfloat16 if dt == "bf16" else None)
        _JAX_TEACHER[key] = np.asarray(
            japply(jm, {"params": teacher_params(arch, deep)}, tok, center), np.float32)
    return _JAX_TEACHER[key]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("deep", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_matches_jax(arch, deep, dt):
    """Eval mode; the teacher's parameters from the arch's JAX dVAE (without
    the deep prompts when ``deep`` is off)."""
    p = teacher_params(arch, deep)
    rng = np.random.default_rng(3)
    tok = rng.normal(size=(2, 16, 32)).astype(np.float32)
    center = rng.normal(size=(2, 16, 3)).astype(np.float32)

    tdt = torch.bfloat16 if dt == "bf16" else None
    tm = PromptedTeacher(WIDTH, DEPTH, 4, 32, 4, deep, arch, tdt).eval()
    tm.load_state_dict(weights.teacher_state(p, "", arch), strict=True)
    with torch.no_grad():
        got = tm(t(tok), t(center))
    assert got.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
    exact = jax_teacher(arch, deep, "f32", tok, center)
    if dt == "f32":
        close(got, exact)
        return
    want = jax_teacher(arch, deep, "bf16", tok, center)
    close(got, want, BF16_ATOL)
    err = float(np.abs(got.float().numpy() - exact).max())
    assert err <= BF16_ERR_RATIO * float(np.abs(want - exact).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_dvae_forward_and_loss_match_jax(arch):
    """Both dVAE classes' recon forward at temperature 0.7 with JAX's sown
    Gumbel draws replayed: every output, the logits and both losses."""
    cfg, jm, v, pts = jax_dvae(arch)
    ret, recon, kld, u, _ = jax_forward(jm, v, pts, 0.7, False)
    model = port_dvae(arch, cfg, v).eval()
    assert model.teacher_arch == arch
    with torch.no_grad():
        got = model(t(pts), 0.7, False, gumbel_u=u)
        g_recon, g_kld = model.get_loss(got)
    for g, w in zip(got, ret):
        close(g, w)
    np.testing.assert_allclose([float(g_recon), float(g_kld)], [recon, kld], rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# one Stage-I step
# ---------------------------------------------------------------------------

def adam_moments(opt_state):
    """The first moments of the trainable leaves of a multi-transform AdamW
    state after its first step, flattened."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(states) == 1
    return {k: x for k, x in flat_np(states[0].mu).items() if isinstance(x, np.ndarray)}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_make_autoencoder_step(arch, monkeypatch):
    """f32, temperature 0.5 and KLD weight 0.05, on 2 clouds of 8 groups,
    with the JAX Stage-I freeze mask (``blocks_`` and ``norm``): CLIP's
    ln_pre and ln_post train there, and so they do here (ROADMAP.md §3,
    fault (b)). Prompt dropout is off on both sides."""
    monkeypatch.setattr(jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    _, _, v, _ = jax_dvae(arch)
    cfg = arch_cfg(arch, num_group=8)
    rng = np.random.default_rng(STEP_SEEDS[arch])
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    u = rng.uniform(1e-10, 1.0, size=(2, 8, 64)).astype(np.float32)
    # behind a barrier u stays a run-time value: a constant u is folded by
    # XLA's compile-time evaluator, whose log differs from the run-time one
    # (on these draws the codebook's gradient moves by 3e-3)
    monkeypatch.setattr(jdvae, "fast_uniform", lambda key, shape, minval, maxval:
                        jax.lax.optimization_barrier(jnp.asarray(u)))
    temp, kldw = 0.5, 0.05
    jm = jax_class(arch)(jcfg(cfg).model)
    params = v["params"]

    frozen = ["visual_embed']['blocks_", "visual_embed']['norm"]  # runner_autoencoder.py:135
    trainable = jbuilder.freeze_mask_from_paths(params, frozen)
    tx, _ = jbuilder.build_optimizer(jcfg(cfg), params, 4, trainable)
    step = make_autoencoder_step(jm, transform_fn=None, trainable_mask=trainable)
    base = jax.random.PRNGKey(7)
    j_state, metrics = step(TrainState.create(v, tx), jnp.asarray(pts), base,
                            jnp.float32(temp), jnp.float32(kldw))
    want_g = {k: mu / np.float32(0.1) for k, mu in adam_moments(j_state.opt_state).items()}
    if arch == "clip":
        assert {"visual_embed.ln_pre.scale", "visual_embed.ln_post.bias"} <= set(want_g)
    assert not any(k.startswith("visual_embed.blocks_") for k in want_g)

    # the port: the same parameters and Gumbel draws
    model = port_dvae(arch, cfg, v)
    builder.freeze_teacher_backbone(model, cast_bf16=False)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    monkeypatch.setattr(model, "forward", functools.partial(model.forward, gumbel_u=t(u)))
    assert min_choice_gap(model, t(pts), temp, kldw, monkeypatch) > 5e-7
    before = {k: x.clone() for k, x in model.state_dict().items()}
    loss, recon, kld = autoencoder_step(model, opt, schedule, t(pts), 0,
                                        {n: torch.Generator() for n in STREAMS}, temp, kldw)
    np.testing.assert_allclose([float(loss), float(recon), float(kld)],
                               [float(metrics["loss"]), float(metrics["recon"]),
                                float(metrics["kld"])], rtol=0, atol=ATOL)

    # the trainable set and its gradients
    rules = tc.dvae_rules(teacher_arch=arch)
    fuse = tc.fuse_bert_qkv if arch == "bert" else dict

    def to_flax(sd):
        p, bs = tc.convert_state_dict(fuse({k: np.asarray(x) for k, x in sd.items()}), rules)
        return flat_np(p), flat_np(bs)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    got_g, _ = to_flax(grads)
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    noise = {k for k, g in want_g.items() if np.abs(g).max() < 1e-6 * g_max}
    assert noise == {"encoder.conv2.bias"}
    for k, g in got_g.items():
        if k not in noise:
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)

    # parameter deltas against optax's first AdamW step and the JAX step
    after = model.state_dict()
    lr = schedule(0)
    deltas, _ = to_flax({k: after[k] - before[k] for k in grads})
    old_p, new_p = flat_np(params), flat_np(j_state.params)
    for k, d in deltas.items():
        p, g = old_p[k].astype(np.float64), got_g[k].astype(np.float64)
        decay = p.ndim > 1 and "bias" not in k and "token" not in k
        first_step = -lr * (g / (np.abs(g) + 1e-8) + (5e-4 * p if decay else 0.0))
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        assert (np.abs(d - first_step) <= ulp + 1e-3 * np.abs(first_step)).all(), k
        want_d = new_p[k] - old_p[k]
        sure = np.abs(want_g[k]) >= 1e-6
        assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
    blocks, frozen_prefixes = {"clip": ("visual_embed.1.", ("visual_embed.1.",)),
                               "bert": ("visual_embed.0.", ("visual_embed.0.",))}[arch]
    for k, x in after.items():
        if k.startswith(frozen_prefixes):
            assert torch.equal(x, before[k]), k
    moved = ["visual_prompt_token", "deep_prompt_tokens", "proj_pre.weight", "codebook"]
    if arch == "clip":
        moved += ["visual_embed.0.weight", "visual_embed.0.bias", "visual_embed.2.weight",
                  "visual_embed.2.bias"]
    for k in moved:
        assert not torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_freeze_and_bf16_cast_follow_the_jax_mask(arch):
    """The frozen set is JAX's mask on the arch's tree; only the blocks'
    matrices go to bf16, norms and 1-D tensors stay f32 (``cast_frozen_bf16``,
    ``act_tpu/engine/builder.py:54-68``)."""
    cfg, _, v, _ = jax_dvae(arch)
    mask = flat_np(jbuilder.freeze_mask_from_paths(
        v["params"], ["visual_embed']['blocks_", "visual_embed']['norm"]))
    cast = flat_np(jbuilder.cast_frozen_bf16(v["params"], ["visual_embed']['blocks_"]))
    model = port_dvae(arch, cfg, v)
    builder.freeze_teacher_backbone(model)
    rules = tc.dvae_rules(teacher_arch=arch)
    fuse = tc.fuse_bert_qkv if arch == "bert" else dict

    def flax_keys(names):
        sd = {n: np.zeros(p.shape, np.float32) for n, p in model.named_parameters() if n in names}
        return set(flat_np(tc.convert_state_dict(fuse(sd), rules)[0]))
    params = dict(model.named_parameters())
    frozen = {n for n, p in params.items() if not p.requires_grad and "_conv." not in n}
    assert flax_keys(frozen) == {k for k, ok in mask.items() if not ok}
    in_bf16 = {n for n, p in params.items() if p.dtype == torch.bfloat16}
    assert flax_keys(in_bf16) == {k for k, x in cast.items() if x.dtype == jnp.bfloat16}
    if arch == "clip":
        assert all(params[f"visual_embed.{i}.{w}"].requires_grad
                   for i in (0, 2) for w in ("weight", "bias"))
        assert params["visual_embed.1.0.attn.in_proj_weight"].dtype == torch.bfloat16
        assert params["visual_embed.1.0.ln_1.weight"].dtype == torch.float32
    else:
        assert params["visual_embed.0.layer.0.attention.self.query.weight"].dtype == torch.bfloat16
        assert params["visual_embed.0.layer.0.output.LayerNorm.weight"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the weight bridges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reference_layout_key_coverage(arch, capsys):
    """Every tensor of the port's state dict, through ``fuse_bert_qkv`` (for
    BERT) and ``dvae_rules(teacher_arch=arch)``, is consumed and lands on the
    JAX tree it came from; none is left over on either side."""
    cfg, _, v, _ = jax_dvae(arch)
    sd = port_dvae(arch, cfg, v).state_dict()
    np_sd = {k: x.numpy() for k, x in sd.items()}
    if arch == "bert":
        np_sd = tc.fuse_bert_qkv(np_sd)
        assert not any(re.search(r"\.(query|key|value)\.", k) for k in np_sd)
    capsys.readouterr()
    got_p, got_bs = tc.convert_state_dict(np_sd, tc.dvae_rules(teacher_arch=arch))
    assert "unmatched" not in capsys.readouterr().out
    for got, want in ((got_p, v["params"]), (got_bs, v["batch_stats"])):
        got, want = flat_np(got), flat_np(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def raw_clip(rng, width, depth):
    """A raw CLIP model state dict's layout: the visual tower's resblocks,
    ln_pre and ln_post, and tensors that are no teacher's (patch embedding,
    the text tower, logit scale)."""
    sd = {"visual.conv1.weight": rng.normal(size=(width, 3, 16, 16)),
          "visual.class_embedding": rng.normal(size=(width,)),
          "transformer.resblocks.0.ln_1.weight": rng.normal(size=(width,)),
          "logit_scale": rng.normal(size=())}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = rng.normal(size=(width,))
        sd[f"visual.{ln}.bias"] = rng.normal(size=(width,))
    for i in range(depth):
        p = f"visual.transformer.resblocks.{i}."
        for name, shape in (("ln_1.weight", (width,)), ("ln_1.bias", (width,)),
                            ("attn.in_proj_weight", (3 * width, width)),
                            ("attn.in_proj_bias", (3 * width,)),
                            ("attn.out_proj.weight", (width, width)),
                            ("attn.out_proj.bias", (width,)),
                            ("ln_2.weight", (width,)), ("ln_2.bias", (width,)),
                            ("mlp.c_fc.weight", (4 * width, width)),
                            ("mlp.c_fc.bias", (4 * width,)),
                            ("mlp.c_proj.weight", (width, 4 * width)),
                            ("mlp.c_proj.bias", (width,))):
            sd[p + name] = rng.normal(size=shape)
    return sd


def raw_bert(rng, width, depth):
    """A raw HuggingFace ``BertForPreTraining`` state dict's layout: the
    encoder layers under ``bert.``, and the embeddings, pooler and heads."""
    sd = {"bert.embeddings.word_embeddings.weight": rng.normal(size=(30, width)),
          "bert.pooler.dense.weight": rng.normal(size=(width, width)),
          "cls.predictions.bias": rng.normal(size=(30,))}
    for i in range(depth):
        p = f"bert.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[p + name + ".weight"] = rng.normal(size=(width, width))
            sd[p + name + ".bias"] = rng.normal(size=(width,))
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = rng.normal(size=(width,))
            sd[p + name + ".bias"] = rng.normal(size=(width,))
        sd[p + "intermediate.dense.weight"] = rng.normal(size=(4 * width, width))
        sd[p + "intermediate.dense.bias"] = rng.normal(size=(4 * width,))
        sd[p + "output.dense.weight"] = rng.normal(size=(width, 4 * width))
        sd[p + "output.dense.bias"] = rng.normal(size=(width,))
    return sd


@pytest.mark.parametrize("arch", ARCHS)
def test_load_teacher_weights_reads_the_raw_layout(arch, tmp_path):
    """A raw CLIP or HuggingFace BERT ``.pth`` loads every teacher tensor,
    each where the JAX package's ``load_clip_visual`` / ``load_hf_bert`` put
    it (``torch_convert.py:303-325``), and nothing else moves."""
    cfg, _, v, _ = jax_dvae(arch)
    rng = np.random.default_rng(5)
    raw = {k: np.asarray(x, np.float32)
           for k, x in (raw_clip if arch == "clip" else raw_bert)(rng, WIDTH, DEPTH).items()}
    path = str(tmp_path / f"{arch}.pth")
    torch.save({"model": {k: torch.from_numpy(x) for k, x in raw.items()}}, path)
    cfg.model.teacher_ckpt = path
    model = port_dvae(arch, cfg, v)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    n = runner.load_teacher_weights(model, cfg.model)
    per_layer, extra = (12, 4) if arch == "clip" else (16, 0)
    assert n == per_layer * DEPTH + extra

    loaded = (tc.load_clip_visual if arch == "clip" else tc.load_hf_bert)(raw)[0]["visual_embed"]
    want = weights.teacher_state({**v["params"]["visual_embed"], **loaded}, "", arch)
    got = model.state_dict()
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert len(changed) == n
    for k, x in want.items():
        np.testing.assert_array_equal(got[k].numpy(), x.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the Stage-II hand-over
# ---------------------------------------------------------------------------

def test_stage_two_takes_a_clip_tokenizer(tmp_path):
    """A Stage-I ``.pth`` of the CLIP dVAE loads strict into Stage II's
    tokenizer (``ACTPromptedDiscreteVAEwithVIT``, as in JAX), whose features
    equal the Stage-I model's with the same pinned noise."""
    cfg, _, v, pts = jax_dvae("clip")
    stage1 = port_dvae("clip", cfg, v).eval()
    path = str(tmp_path / "ckpt-best.pth")
    torch.save({"base_model": stage1.state_dict()}, path)
    p_cfg = ConfigDict(dict(tiny_cfg()))
    p_cfg.dvae_config.visual_embed_type = "clip_ViT-B/16"
    p_cfg.dvae_config.ckpt = path
    model = rp.build_pretrain_model(p_cfg, seed=0)
    tok = model.dvae_tokenizer
    n = rp.load_dvae_ckpt(model, p_cfg.dvae_config)
    assert n == len(tok.state_dict()) and tok.teacher_arch == "clip"
    tok.eval()
    rng = np.random.default_rng(6)
    nbr = t((0.2 * rng.normal(size=(2, 16, 8, 3))).astype(np.float32))
    center = t(rng.normal(size=(2, 16, 3)).astype(np.float32))
    u = t(rng.uniform(1e-10, 1.0, size=(2, 16, 64)).astype(np.float32))
    with torch.no_grad():
        want = stage1.forward_tokenizer_features(nbr, center, gumbel_u=u)
        got = tok.forward_tokenizer_features(nbr, center, gumbel_u=u)
    assert torch.equal(got, want)
    rp.freeze_tokenizer(model, ConfigDict(dict(model=p_cfg)))
    assert tok.visual_embed[1][0].attn.in_proj_weight.dtype == torch.bfloat16


def test_stage_two_refuses_a_bert_tokenizer():
    """Fault (a): the JAX Stage II builds the ViT tokenizer class for a BERT
    dVAE config and loads its layers into pre-LN blocks; the port raises."""
    cfg = ConfigDict(dict(tiny_cfg()))
    cfg.dvae_config.NAME = "ACTPromptedDiscreteVAEwithBERT"
    with pytest.raises(ValueError, match=r"fault \(a\)"):
        ACT_PointDistillation(cfg)
    with pytest.raises(ValueError, match=r"fault \(a\)"):
        rp.build_pretrain_model(cfg, seed=0)


def test_full_width_teachers_build():
    """CLIP ViT-B/16's visual transformer and bert-base (768 x 12, 12 heads,
    MLP 3072) with 64 deep prompts, on the meta device: 12 C^2 + 13 C
    parameters a block, and CLIP's ln_pre and ln_post."""
    C = 768
    for arch in ARCHS:
        with torch.device("meta"):
            tm = PromptedTeacher(C, 12, 12, 384, 64, True, arch)
        blocks = [m for m in tm.modules()
                  if isinstance(m, (common.CLIPBlock, common.PostLNBlock))]
        assert len(blocks) == 12
        n = sum(p.numel() for name, p in tm.named_parameters() if name.startswith("visual_embed."))
        assert n == 12 * (12 * C * C + 13 * C) + (4 * C if arch == "clip" else 0)
        assert tuple(tm.deep_prompt_tokens.shape) == (11, 64, C)
