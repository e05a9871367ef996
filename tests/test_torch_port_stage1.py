"""The port's Stage-I slice held against the JAX package on the CPU.

The dVAE autoencoder (``DiscreteVAE`` and the ViT-prompted one) at the widths
of the JAX runner's smoke mode (``runner_autoencoder.py:86-102``: 32-wide
encoder, tokens and decoder, 64 tokens, a 2-block teacher 48 wide with 4
prompts) on 16 groups of 8 points (the train step: 2 clouds of 8 groups), f32. JAX parameters are drawn, perturbed
away from their trivial init and carried over by the weight bridge; the
Gumbel draws are pinned by replaying the flax model's sown ``gumbel_u`` and
prompt dropout is neutralised on both sides. Inputs are numpy arrays from a
seed. Tolerances (as the Stage-II tests):

- forward outputs, losses and BatchNorm statistics: atol 1e-5 (f32, sum order
  only); neighbourhoods and group indices exactly;
- gradients: within 1e-4 of each tensor's largest gradient, except where the
  JAX gradient is zero up to rounding (below 1e-6 of the largest gradient
  anywhere);
- parameter deltas after the AdamW step: within 2 f32 ulp of the parameter
  plus 1e-3 of the delta, against optax's first step from the port's own
  clipped gradient, and against the JAX step's delta wherever the clipped
  |g| >= 1e-6;
- the metrics: F-Score exactly, CDL1 and CDL2 within 1e-5 relative (JAX's
  dense expanded-form distances above 4096 pairs).
"""
import copy
import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.engine import builder as jbuilder
from act_tpu.engine import runner_autoencoder as jrunner
from act_tpu.engine import torch_convert as tc
from act_tpu.engine.checkpoint import flatten_keys
from act_tpu.engine.train_state import TrainState, make_autoencoder_step
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.models import common as jcommon
from act_tpu.models.dvae import ACTPromptedDiscreteVAEwithVIT as JViT
from act_tpu.models.dvae import DiscreteVAE as JPlain
from act_tpu.utils.config import ConfigDict as JConfigDict
from act_tpu.utils.metrics import Metrics as JMetrics

from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine.runner_autoencoder import (get_kld_weight, get_temp,
                                                     run_autoencoder_steps, validate)
from act_tpu_torch.engine.serve import load_config
from act_tpu_torch.engine.train_state import STREAMS, autoencoder_step
from act_tpu_torch.models import (ACT_PointDistillation, ACTPromptedDiscreteVAEwithVIT,
                                  DiscreteVAE, common)
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops.reference import pair_distance
from act_tpu_torch.utils.config import ConfigDict
from act_tpu_torch.utils.metrics import Metrics

from tests.test_torch_port_stage2 import RNGS, close, jax_variables, japply, t, tiny_cfg
from tests.test_torch_port_train import flat_np

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
VIT_CFG = "cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml"
PLAIN_CFG = "cfgs/autoencoder/pointbert_dvae.yaml"
FROZEN = ["visual_embed']['blocks_", "visual_embed']['norm"]  # runner_autoencoder.py:135


def smoke_cfg(path=VIT_CFG, clip=None):
    """The YAML at the JAX smoke widths, G=16, M=8, 128 points, B=4, f32."""
    cfg = load_config(path)
    cfg.total_bs = 4
    cfg.grad_norm_clip = clip
    m = cfg.model
    m.encoder_dims = m.tokens_dims = m.decoder_dims = 32
    m.num_tokens = 64
    m.num_group, m.group_size = 16, 8
    m.dtype = "f32"
    if "visual_embed_dim" in m:
        m.visual_embed_dim, m.visual_embed_depth = 48, 2
        m.visual_embed_heads, m.num_prompt_token = 4, 4
    cfg.dataset.train.others.npoints = 128
    return cfg


def jcfg(cfg):
    return JConfigDict(dict(cfg))


def build(cfg, v):
    """The port's model of ``cfg`` with the JAX variables ``v``."""
    cls = ACTPromptedDiscreteVAEwithVIT if cfg.model.NAME.startswith("ACT") else DiscreteVAE
    model = cls(cfg.model)
    model.load_state_dict(weights.dvae_state_dict(v["params"], v["batch_stats"]), strict=True)
    return model


def to_flax(sd):
    """A port-keyed dict -> (flat flax params, flat flax batch stats)."""
    p, bs = tc.convert_state_dict({k: np.asarray(x) for k, x in sd.items()}, tc.dvae_rules())
    return flatten_keys(p), flatten_keys(bs)


def jax_model(cfg, rng, pts):
    jm = (JViT if cfg.model.NAME.startswith("ACT") else JPlain)(jcfg(cfg).model)
    return jm, jax_variables(jm, rng, pts)


@pytest.fixture
def no_prompt_dropout(monkeypatch):
    monkeypatch.setattr(jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_folding_decoder_matches_jax(rng, train):
    f = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jm = jcommon.FoldingDecoder(8)
    v = jax_variables(jm, rng, f)
    tm = common.FoldingDecoder(16, 8)
    tm.load_state_dict(weights.folding_decoder_state(v["params"], v["batch_stats"], ""),
                       strict=True)
    assert tm.final_conv[0].weight.shape == (512, 21, 1)
    assert not tm.final_conv[0].bias.requires_grad and not tm.final_conv[3].bias.requires_grad
    tm.train(train)
    (coarse, fine), new = japply(jm, v, f, train=train, mutable=["batch_stats"])
    got = tm(t(f))
    close(got[0], coarse)
    close(got[1], fine)
    assert got[0].shape == (2, 5, 2, 3) and got[1].shape == (2, 5, 8, 3)
    want_bs = flat_np(new["batch_stats"])
    for name, idx in (("fbn1", 1), ("fbn2", 4)):
        bn = tm.final_conv[idx]
        close(bn.running_mean, want_bs[f"{name}.mean"])
        close(bn.running_var, want_bs[f"{name}.var"])


def test_gumbel_softmax_from_u_matches_jax(rng):
    logits = rng.normal(size=(3, 4, 10)).astype(np.float32)
    u = rng.uniform(1e-10, 1.0, size=logits.shape).astype(np.float32)
    for hard in (False, True):
        want = jcommon.gumbel_softmax_from_u(jnp.asarray(u), jnp.asarray(logits), 0.5, hard)
        got = common.gumbel_softmax_from_u(t(u), t(logits), 0.5, hard)
        close(got, want)


# ---------------------------------------------------------------------------
# the whole dVAE
# ---------------------------------------------------------------------------

def jax_forward(jm, v, pts, temperature, hard, train=False, rngs=RNGS):
    """The recon forward and its losses; the sown uniforms and new batch stats."""
    def fn(v, pts):
        ret, new = jm.apply(v, pts, temperature, hard, train=train, rngs=rngs,
                            mutable=["intermediates", "batch_stats"])
        recon, kld = jm.apply(v, ret, pts, method=jm.get_loss)
        return ret, recon, kld, new
    ret, recon, kld, new = jax.jit(fn)(v, jnp.asarray(pts))
    return ret, float(recon), float(kld), t(new["intermediates"]["gumbel_u"][0]), new


@pytest.mark.parametrize("path,hard", [(VIT_CFG, False), (VIT_CFG, True), (PLAIN_CFG, False)])
def test_dvae_forward_and_loss_match_jax(rng, path, hard):
    cfg = smoke_cfg(path)
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm, v = jax_model(cfg, rng, pts)
    ret, recon, kld, u, _ = jax_forward(jm, v, pts, 0.7, hard)
    model = build(cfg, v).eval()
    assert model.has_teacher == path.endswith("transformer.yaml")
    with torch.no_grad():
        got = model(t(pts), 0.7, hard, gumbel_u=u)
        g_recon, g_kld = model.get_loss(got)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ret[4]))  # neighbourhoods
    for g, w in zip(got, ret):
        close(g, w)
    np.testing.assert_allclose([float(g_recon), float(g_kld)], [recon, kld], rtol=0, atol=ATOL)


def min_choice_gap(model, pts, temp, kldw, monkeypatch):
    """The smallest gap between the best and the second-best candidate of
    every max-pool (``torch.amax``) and every Chamfer minimum of a train-mode
    loss and backward of a copy of ``model``, relative to the largest value
    of the pooled tensor."""
    gaps = []

    def gap(best, second):
        gaps.append(float((best - second).min() / best.abs().max()))

    amax, ref = torch.amax, chamfer_mod.chamfer_ref

    def rec_amax(x, dim, keepdim=False):
        top2 = x.detach().topk(2, dim=dim).values
        gap(top2.select(dim, 0), top2.select(dim, 1))
        return amax(x, dim=dim, keepdim=keepdim)

    def rec_chamfer(x, y):
        d = pair_distance(x, y)
        for dim in (1, 2):
            top2 = (-d).topk(2, dim=dim).values
            gap(top2.select(dim, 0), top2.select(dim, 1))
        return ref(x, y)
    with monkeypatch.context() as m:
        m.setattr(torch, "amax", rec_amax)
        m.setattr(chamfer_mod, "chamfer_ref", rec_chamfer)
        probe = copy.deepcopy(model).train()
        recon, kld = probe.get_loss(probe(pts, temp, False))
        (recon + kldw * kld).backward()
    return min(gaps)


# clouds and weights on which no max-pool or Chamfer choice of the step is
# near a tie (see the test): 2 clouds of 8 groups, so fewer choices to clear
STEP_SEED = 2


def test_one_train_step_matches_make_autoencoder_step(no_prompt_dropout, monkeypatch):
    """f32, temperature 0.5 and KLD weight 0.05 (both terms count), a
    grad-norm clip of 0.5 that engages.

    A max over candidates is not differentiable where two candidates tie: f32
    rounding that differs between the frameworks by ~1e-7 can route a
    gradient to the other candidate of a near tie and move every gradient
    upstream of it. The seed is chosen so that every such choice of the step
    (the encoder's and the DGCNNs' max-pools, the Chamfer minima) is clear by
    more than 5e-7 of the pooled tensor's largest value (four f32 ulps at
    1.0), and the test checks that margin first."""
    rng = np.random.default_rng(STEP_SEED)
    cfg = smoke_cfg(clip=0.5)
    cfg.model.num_group = 8
    temp, kldw = 0.5, 0.05
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm, v = jax_model(cfg, rng, pts)
    params, stats = v["params"], v["batch_stats"]

    # JAX: the step's draws, its gradients, and the step itself
    base = jax.random.PRNGKey(7)
    rngs = jax_step_rngs(base, jnp.int32(0))
    rngs.pop("augment")

    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        ret, new = jm.apply(variables, jnp.asarray(pts), temp, False, train=True, rngs=rngs,
                            mutable=["batch_stats", "intermediates"])
        recon, kld = jm.apply(variables, ret, pts, method=jm.get_loss)
        return recon + jnp.float32(kldw) * kld, (recon, kld, new["intermediates"])
    (j_loss, (j_recon, j_kld, inter)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    u = t(inter["gumbel_u"][0])
    trainable = jbuilder.freeze_mask_from_paths(params, FROZEN)
    tx, _ = jbuilder.build_optimizer(jcfg(cfg), params, 4, trainable)
    step = make_autoencoder_step(jm, transform_fn=None, trainable_mask=trainable)
    j_state, metrics = step(TrainState.create(v, tx), jnp.asarray(pts), base,
                            jnp.float32(temp), jnp.float32(kldw))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=0, atol=1e-6)

    # port: the same parameters, the Gumbel draws pinned to JAX's
    model = build(cfg, v)
    builder.freeze_teacher_backbone(model, cast_bf16=False)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    monkeypatch.setattr(model, "forward", functools.partial(model.forward, gumbel_u=u))
    assert min_choice_gap(model, t(pts), temp, kldw, monkeypatch) > 5e-7
    before = {k: x.clone() for k, x in model.state_dict().items()}
    gens = {name: torch.Generator() for name in STREAMS}
    raw = {}
    clip_fn = torch.nn.utils.clip_grad_norm_

    def clip_and_keep(params, max_norm):
        params = list(params)
        raw.update({id(p): p.grad.clone() for p in params})
        return clip_fn(params, max_norm)
    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", clip_and_keep)
    loss, recon, kld = autoencoder_step(model, opt, schedule, t(pts), 0, gens, temp, kldw,
                                        grad_norm_clip=cfg.grad_norm_clip)
    np.testing.assert_allclose([float(loss), float(recon), float(kld)],
                               [float(j_loss), float(j_recon), float(j_kld)], rtol=0, atol=ATOL)

    # gradients before the clip, and the clip engaged
    got_g, _ = to_flax({n: raw[id(p)] for n, p in model.named_parameters() if p.requires_grad})
    want_g = {k: g for k, g in flat_np(j_grads).items()
              if not any(k.startswith(f) for f in ("visual_embed.blocks_", "visual_embed.norm"))}
    assert sorted(got_g) == sorted(want_g)
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want_g.values()))
    assert norm > cfg.grad_norm_clip
    g_max = max(np.abs(g).max() for g in want_g.values())
    noise = {k for k, g in want_g.items() if np.abs(g).max() < 1e-6 * g_max}
    assert noise == {"encoder.conv2.bias"}
    for k, g in got_g.items():
        if k not in noise:
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)

    # parameter deltas, BN statistics, the frozen backbone
    after = model.state_dict()
    lr = schedule(0)
    scale = cfg.grad_norm_clip / norm  # the clip's factor
    clipped = {k: g * (cfg.grad_norm_clip / (norm + 1e-6)) for k, g in got_g.items()}
    deltas, _ = to_flax({k: after[k] - before[k] for k in after
                         if after[k].is_floating_point() and not k.startswith("visual_embed.")})
    old_p, new_p = flat_np(params), flat_np(j_state.params)
    for k, d in deltas.items():
        if k not in want_g:
            continue  # running statistics
        p, g = old_p[k].astype(np.float64), clipped[k].astype(np.float64)
        decay = p.ndim > 1 and "bias" not in k and "token" not in k
        first_step = -lr * (g / (np.abs(g) + 1e-8) + (5e-4 * p if decay else 0.0))
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        assert (np.abs(d - first_step) <= ulp + 1e-3 * np.abs(first_step)).all(), k
        want_d = new_p[k] - old_p[k]
        sure = np.abs(want_g[k]) * scale >= 1e-6  # the clipped gradient well above eps
        assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
    _, got_bs = to_flax({k: x for k, x in after.items() if "running" in k})
    want_bs = flat_np(j_state.batch_stats)
    assert sorted(got_bs) == sorted(want_bs)
    for k, x in got_bs.items():
        np.testing.assert_allclose(x, want_bs[k], rtol=0, atol=ATOL, err_msg=k)
    for k, x in after.items():
        if k.startswith("visual_embed."):
            assert torch.equal(x, before[k]), k
    for k in ("visual_prompt_token", "deep_prompt_tokens", "proj_pre.weight", "codebook",
              "decoder.mlp.0.weight", "encoder.first_conv.0.weight"):
        assert not torch.equal(after[k], before[k]), k


# ---------------------------------------------------------------------------
# runner pieces
# ---------------------------------------------------------------------------

def test_anneals_match_jax():
    cfg = load_config(VIT_CFG)
    for n_itr in (0, 9999, 10000, 60000, 200000):
        assert get_temp(cfg, n_itr) == jrunner.get_temp(jcfg(cfg), n_itr), n_itr
        assert get_kld_weight(cfg, n_itr) == jrunner.get_kld_weight(jcfg(cfg), n_itr), n_itr
    assert get_kld_weight(cfg, 9999) == 0.0 and get_temp(cfg, 0) == 1.0
    assert math.isclose(get_kld_weight(cfg, 60000), 0.05, rel_tol=1e-12)


@pytest.mark.parametrize("N,M", [(64, 48), (2048, 1024)])
def test_metrics_match_jax(rng, N, M):
    """Tight clouds, so that the 0.01 F-Score threshold splits the points."""
    gt = (0.02 * rng.normal(size=(M, 3))).astype(np.float32)
    pred = (0.02 * rng.normal(size=(N, 3))).astype(np.float32)
    got, want = Metrics.get(t(pred), t(gt)), JMetrics.get(pred, gt)
    assert 0.0 < got[0] < 1.0 and got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=0)


def test_metrics_state_and_order():
    a = Metrics("CDL1", {"F-Score": 0.5, "CDL1": 10.0})
    assert a.state_dict() == {"F-Score": 0.5, "CDL1": 10.0, "CDL2": 32767.0}
    assert a.better_than(None) and a.better_than(Metrics("CDL1", [0.1, 11.0, 1.0]))
    assert not a.better_than(Metrics("CDL1", [0.1, 9.0, 1.0]))
    assert Metrics("F-Score", a).better_than(Metrics("F-Score", [0.4, 1.0, 1.0]))


@pytest.mark.parametrize("path", [VIT_CFG, PLAIN_CFG])
def test_dvae_state_dict_round_trip(rng, path):
    """flax -> dvae_state_dict -> torch_convert.convert_state_dict gives back
    the flax tree, and the port's own state dict has the bridge's keys and
    shapes."""
    cfg = smoke_cfg(path)
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    _, v = jax_model(cfg, rng, pts)
    sd = weights.dvae_state_dict(v["params"], v["batch_stats"])
    own = build(cfg, v).state_dict()
    assert {k: tuple(x.shape) for k, x in own.items()} == {k: tuple(x.shape) for k, x in sd.items()}
    got_p, got_bs = to_flax(sd)
    for got, want in ((got_p, flat_np(v["params"])), (got_bs, flat_np(v["batch_stats"]))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stage_two_tokenizer_has_no_decoder():
    """As in flax, where the never-called decoder has no parameters."""
    model = ACT_PointDistillation(ConfigDict(dict(tiny_cfg())))
    assert not hasattr(model.dvae_tokenizer, "decoder")
    assert not any(k.startswith("dvae_tokenizer.decoder.") for k in model.state_dict())
    assert hasattr(ACTPromptedDiscreteVAEwithVIT(smoke_cfg().model), "decoder")


def test_freeze_teacher_backbone():
    model = ACTPromptedDiscreteVAEwithVIT(smoke_cfg().model)
    builder.freeze_teacher_backbone(model)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in dict(model.named_parameters())
                      if n.startswith("visual_embed.") or n.endswith("_conv.0.bias")
                      or n == "decoder.final_conv.3.bias"}
    dt = {n: p.dtype for n, p in model.named_parameters()}
    assert dt["visual_embed.0.0.attn.qkv.weight"] == torch.bfloat16
    assert dt["visual_embed.0.0.attn.qkv.bias"] == torch.float32
    assert dt["visual_embed.1.weight"] == torch.float32
    assert dt["proj_pre.weight"] == dt["deep_prompt_tokens"] == dt["codebook"] == torch.float32


def test_run_autoencoder_steps_on_cpu():
    """The entry point on the tiny model at iteration 60 000 (temperature
    below 1, KLD weight 0.05): finite losses, the teacher backbone bit for bit
    unchanged, the prompts, decoder, encoder and BatchNorm statistics moved;
    then ``validate``."""
    cfg = smoke_cfg()
    cfg.model.freeze_visual_embed = True
    run = run_autoencoder_steps(cfg, 2, device="cpu", start_itr=60000)
    assert len(run.losses) == 2 and all(math.isfinite(x) for x in run.losses + run.kld)
    assert run.temps == [get_temp(cfg, 60000), get_temp(cfg, 60001)] and run.temps[0] < 1.0
    assert math.isclose(run.kld_weights[0], 0.05, rel_tol=1e-12)
    for loss, recon, kld, w in zip(run.losses, run.recon, run.kld, run.kld_weights):
        assert math.isclose(loss, recon + w * kld, rel_tol=1e-5)
    ref = run_autoencoder_steps(cfg, 0, device="cpu").model.state_dict()
    after = run.model.state_dict()
    for k, x in after.items():
        if k.startswith("visual_embed."):
            assert torch.equal(x, ref[k]), k
    for k in ("visual_prompt_token", "decoder.final_conv.6.weight",
              "encoder.second_conv.3.weight", "decoder.final_conv.1.running_mean"):
        assert not torch.equal(after[k], ref[k]), k
    assert after["visual_embed.0.0.mlp.fc1.weight"].dtype == torch.bfloat16
    batches = [np.random.default_rng(i).normal(size=(4, 128, 3)) for i in range(2)]
    one = run_autoencoder_steps(cfg, 2, device="cpu", batches=batches)
    assert run_autoencoder_steps(cfg, 2, device="cpu", batches=batches).losses == one.losses
    metrics, per_cloud = validate(run.model, [b[0] for b in batches])
    assert len(per_cloud) == 2 and all(math.isfinite(x) for row in per_cloud for x in row)
    assert metrics.state_dict()["CDL1"] == pytest.approx((per_cloud[0][1] + per_cloud[1][1]) / 2)
    assert validate(run.model, [b[0] for b in batches])[1] == per_cloud


def test_run_autoencoder_steps_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_autoencoder_steps(smoke_cfg(), 1)
