"""The port's ACT_PointBERT held against the JAX package on the CPU.

The tiny PointBERT configuration (``__graft_entry__._pretrain_cfg(tiny=True)``
with the overrides of ``tools/bench_suite.py``'s PointBERT setup, K=8) on 4
clouds of 128 points. JAX parameters are drawn, perturbed away from their
trivial init and carried to the port by ``weights.pointbert_state_dict``;
the JAX queue comes across with them (each side seeds its own). The masks and
the mixup draws are pinned by replaying what the flax model sows. Tolerances:

- the three losses: atol 1e-5 (f32 on both sides, sum order only); the queue
  atol 1e-6; the queue pointer and the token labels exactly;
- one train step: gradients of ``transformer_q`` within 1e-4 of each tensor's
  largest gradient and AdamW deltas within 2 f32 ulp plus 1e-3 of the delta,
  the rules of ``tests/test_torch_port_train.py``; the EMA'd ``transformer_k``
  within 2 f32 ulp of its value plus 1e-3 of its step, and bit-equal to the
  EMA recomputed in numpy from the port's own q; running statistics atol 1e-5;
- features (``forward_eval``) of both pretrain models: atol 1e-5.
"""
import functools
import math
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from act_tpu.engine import builder as jbuilder
from act_tpu.engine import checkpoint as jckpt
from act_tpu.engine import torch_convert as tc
from act_tpu.engine.train_state import TrainState, make_pretrain_step
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.models import ACT_PointBERT as JBERT
from act_tpu.models import ACT_PointDistillation as JDistill

from act_tpu_torch import ops, serve_http
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import runner_pretrain as runner
from act_tpu_torch.engine.serve import build_features_fn
from act_tpu_torch.engine.train_state import STREAMS, ema_update, pretrain_step
from act_tpu_torch.models import (ACT_PointBERT, ACT_PointDistillation, MaskTransformer,
                                  TokenAllMaskTransformer)
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_fullgraph import TorchPointBERT, tiny_pointbert_cfg
from tests.test_torch_port_model import perturb
from tests.test_torch_port_serve import request
from tests.test_torch_port_stage1_run import shapenet_node
from tests.test_torch_port_stage2 import RNGS, japply
from tests.test_torch_port_stage2_run import probe_node

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
BS, NPTS = 4, 128
# the tokenizer tensors of the reference layout that the JAX PointBERT never
# creates (flax makes no parameters for the submodules that do not run: only
# the encoder and dgcnn_1 label the groups; the codebook, a parameter of the
# dVAE itself, is created)
JAX_NEVER = ("dvae.dgcnn_2.", "dvae.visual_embed.", "dvae.proj_pre.",
             "dvae.proj_post.", "dvae.visual_pos_embed.", "dvae.visual_prompt_token",
             "dvae.visual_prompt_pos", "dvae.deep_prompt_tokens", "dvae.deep_prompt_pos")


def bert_model_cfg(moco=False, return_all=False, scan=None):
    cfg = graft._pretrain_cfg(tiny=True)
    cfg.NAME = "ACT_PointBERT"
    cfg.m, cfg.T, cfg.K = 0.999, 0.07, 8
    tcfg = cfg.transformer_config
    tcfg.mask_ratio = [0.25, 0.45]
    tcfg.drop_path_rate = 0.0
    tcfg.moco_loss, tcfg.dvae_loss, tcfg.cutmix_loss = moco, True, True
    tcfg.return_all_tokens = return_all
    if scan is not None:
        tcfg.scan = scan
    return cfg


def train_cfg(model=None, warmup_epochs=10):
    return ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=1e-3, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=warmup_epochs)),
        dataset=dict(train=dict(others=dict(npoints=NPTS))), total_bs=BS,
        model=dict(model or bert_model_cfg(moco=True))))


def t(a):
    return torch.from_numpy(np.array(a))


def jax_vars(jm, rng, pts):
    """Perturbed params and batch statistics of a flax pretrain model (``init``
    jitted); the buffers as drawn."""
    v = jax.device_get(jax.jit(lambda x: jm.init(RNGS, x))(jnp.asarray(pts)))
    return {k: x if k == "buffers" else perturb(x, rng) for k, x in v.items()}


def port_bert(cfg, v):
    """The port's ACT_PointBERT with the JAX variables; the tokenizer tensors
    JAX never creates keep a seeded init."""
    model = ACT_PointBERT(ConfigDict(dict(cfg)))
    model.init_weights(torch.Generator().manual_seed(0))
    sd = weights.pointbert_state_dict(v["params"], v["batch_stats"], v["buffers"])
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and missing and all(k.startswith(JAX_NEVER) for k in missing)
    return model


def sown_pins(ii):
    q_mask, mix_mask = (t(m) for m in ii["transformer_q"]["mask"])
    masks = (q_mask, mix_mask, t(ii["transformer_k"]["mask"][0]))
    return masks, (t(ii["mixup_ratio"][0]), t(ii["mixup_mask"][0]))


@pytest.fixture(scope="module")
def bert():
    """(pts, cfg, JAX variables) of the tiny PointBERT with the MoCo loss on."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(BS, NPTS, 3)).astype(np.float32)
    cfg = bert_model_cfg(moco=True)
    return pts, cfg, jax_vars(JBERT(cfg), rng, pts)


# ---------------------------------------------------------------------------
# (a) the losses, the masks' replay and the queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moco,return_all", [(True, False), (False, True)])
def test_losses_and_queue_match_jax(bert, moco, return_all):
    """Eval-mode ``apply`` with the sown masks and mixup draws replayed: the
    grouping and the tokenizer's labels exactly, the three losses within
    1e-5, the advanced queue within 1e-6 and its pointer exactly."""
    pts, _, v = bert
    cfg = bert_model_cfg(moco=moco, return_all=return_all)
    jm = JBERT(cfg)
    (j_losses, aux) = japply(jm, v, pts, train=False, rngs=RNGS,
                             mutable=["intermediates", "buffers"])
    ii = aux["intermediates"]
    masks, mixup = sown_pins(ii)
    assert masks[0].any() and masks[1].any() and not masks[0].all()
    model = port_bert(cfg, v).eval()
    nbr, ctr = ops.group_points(t(pts), 16, 8)
    assert torch.equal(nbr, t(ii["neighborhood"][0])) and torch.equal(ctr, t(ii["center"][0]))
    want_labels = japply(jm, v, ii["neighborhood"][0], ii["center"][0],
                         method=lambda m, n, c: m.dvae.forward_tokenizer(n, c))
    with torch.no_grad():
        assert torch.equal(model.dvae.forward_tokenizer(nbr, ctr), t(want_labels))
        got = model(t(pts), masks=masks, mixup=mixup)
    if not moco:
        assert float(got[0]) == float(j_losses[0]) == 0.0
    for g, w in zip(got, j_losses):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(model.queue.numpy(), np.asarray(aux["buffers"]["queue"]),
                               rtol=0, atol=1e-6)
    assert int(model.queue_ptr) == int(aux["buffers"]["queue_ptr"]) == BS


# ---------------------------------------------------------------------------
# (b) one f32 train step: make_pretrain_step(loss_is_tuple, ema_momentum)
# ---------------------------------------------------------------------------

def to_flax(sd):
    p, bs = tc.convert_state_dict({k: np.asarray(x) for k, x in sd.items()},
                                  tc.act_pointbert_rules())
    return jckpt.flatten_keys(p), jckpt.flatten_keys(bs)


def flat_np(tree):
    return jckpt.flatten_keys(jax.tree_util.tree_map(np.asarray, tree))


def jax_bert_grads(pts, cfg, v):
    """JAX's f32 train-mode loss of ACT_PointBERT on ``pts`` from the
    variables ``v`` and its gradients: (the loss, the sown (masks, mixup
    draws), the gradients)."""
    jm = JBERT(cfg)
    stats, bufs = v["batch_stats"], v["buffers"]
    rngs = jax_step_rngs(jax.random.PRNGKey(7), jnp.int32(0))
    rngs.pop("augment")

    def loss_fn(p):
        out, new = jm.apply({"params": p, "batch_stats": stats, "buffers": bufs},
                            jnp.asarray(pts), train=True, rngs=rngs,
                            mutable=["batch_stats", "buffers", "intermediates"])
        return sum(out), new
    (j_loss, inter), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return j_loss, sown_pins(inter["intermediates"]), j_grads


def jax_bert_state(pts, cfg, v):
    """JAX's f32 train step of ACT_PointBERT on ``pts`` from the variables
    ``v`` (``make_pretrain_step(loss_is_tuple=True, ema_momentum=m)``, the
    tokenizer and k frozen): (the state after it, the step's loss)."""
    params = v["params"]
    trainable = jbuilder.freeze_mask_from_paths(params, ["dvae", "transformer_k"])
    tx, _ = jbuilder.build_optimizer(train_cfg(cfg), params, 4, trainable)
    step = make_pretrain_step(JBERT(cfg), transform_fn=None, loss_is_tuple=True,
                              ema_momentum=float(cfg.m), trainable_mask=trainable)
    j_state, metrics = step(TrainState.create(v, tx), jnp.asarray(pts), jax.random.PRNGKey(7))
    return j_state, float(metrics["loss"])


def test_one_train_step_matches_make_pretrain_step(bert):
    """The step's loss, q's gradients and AdamW deltas, the EMA'd k, the
    running statistics of q (two passes), k and the tokenizer, the queue and
    its pointer, and the frozen tensors (the tolerances of the module
    docstring)."""
    pts, cfg, v = bert
    m = float(cfg.m)
    params, stats = v["params"], v["batch_stats"]
    j_loss, (masks, mixup), j_grads = jax_bert_grads(pts, cfg, v)
    j_state, step_loss = jax_bert_state(pts, cfg, v)
    assert step_loss == float(j_loss)
    tcfg = train_cfg(cfg)

    model = port_bert(cfg, v)
    runner.freeze_tokenizer(model, ConfigDict(dict(model=dict(cfg, frozen_bf16=False))))
    opt, schedule = builder.build_optimizer(tcfg, model, 4)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    trained = {n for n, p in model.named_parameters() if id(p) in in_opt}
    assert trained == {n for n, p in model.named_parameters() if p.requires_grad} == {
        n for n, _ in model.named_parameters()
        if n.startswith("transformer_q.") and not n.endswith("_conv.0.bias")}
    model.forward = functools.partial(model.forward, masks=masks, mixup=mixup)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    gens = {name: torch.Generator() for name in STREAMS}
    loss = pretrain_step(model, opt, schedule, t(pts), 0, gens, transform=None,
                         ema_momentum=m)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0, atol=ATOL)

    check_bert_step({n: p.grad for n, p in model.named_parameters() if p.requires_grad},
                    before, model.state_dict(), schedule(0), v, j_grads, j_state, m)


def check_bert_step(grads, before, after, lr, v, j_grads, j_state, m):
    """A port ACT_PointBERT step (q's ``grads``, the state dict ``before`` and
    ``after`` it, at ``lr``) against JAX's from the variables ``v``: q's
    gradients and AdamW deltas, the EMA'd k, the running statistics, the
    queue and its pointer, the frozen tokenizer (the tolerances of the module
    docstring)."""
    params, stats = v["params"], v["batch_stats"]
    # q's gradients
    got_g, _ = to_flax(grads)
    want_g = {k: g for k, g in flat_np(j_grads).items() if k.startswith("transformer_q.")}
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    noise = {k for k, g in want_g.items() if np.abs(g).max() < 1e-6 * g_max}
    assert noise == {"transformer_q.encoder.conv2.bias"}
    for k, g in got_g.items():
        if k not in noise:
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)

    # AdamW deltas of q, the EMA of k
    old_p, new_p = flat_np(params), flat_np(j_state.params)
    deltas, _ = to_flax({k: after[k] - before[k] for k in after
                         if k.startswith("transformer_q.") and "running" not in k
                         and "num_batches" not in k})
    for k, d in deltas.items():
        p, g = old_p[k].astype(np.float64), got_g[k].astype(np.float64)
        decay = p.ndim > 1 and "bias" not in k and "token" not in k
        first_step = -lr * (g / (np.abs(g) + 1e-8) + (0.05 * p if decay else 0.0))
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        assert (np.abs(d - first_step) <= ulp + 1e-3 * np.abs(first_step)).all(), k
        want_d = new_p[k] - old_p[k]
        sure = np.abs(want_g[k]) >= 1e-6
        assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
    got_k, _ = to_flax({k: x for k, x in after.items() if k.startswith("transformer_k.")
                        and "running" not in k and "num_batches" not in k})
    new_q, _ = to_flax({k: x for k, x in after.items() if k.startswith("transformer_q.")})
    f32m = np.float32(m)
    for k, x in got_k.items():
        q_key = "transformer_q." + k[len("transformer_k."):]
        host = old_p[k] * f32m + new_q[q_key] * np.float32(1.0 - m)
        np.testing.assert_array_equal(x, host, err_msg=k)
        want = new_p[k]
        assert (np.abs(x - want) <= 2 * np.spacing(np.abs(want))
                + 1e-3 * np.abs(want - old_p[k])).all(), k

    # running statistics, the queue, the frozen tokenizer
    _, got_bs = to_flax({k: x for k, x in after.items() if "running" in k})
    want_bs = flat_np(j_state.batch_stats)
    assert sorted(got_bs) == sorted(want_bs)
    assert {k.split(".")[0] for k in want_bs} == {"transformer_q", "transformer_k", "dvae"}
    for k, x in got_bs.items():
        np.testing.assert_allclose(x, want_bs[k], rtol=0, atol=ATOL, err_msg=k)
        assert not np.array_equal(x, flat_np(stats)[k]), k
    np.testing.assert_allclose(after["queue"].numpy(), np.asarray(j_state.buffers["queue"]),
                               rtol=0, atol=1e-6)
    assert int(after["queue_ptr"]) == int(j_state.buffers["queue_ptr"]) == BS
    for k, x in after.items():
        if k.startswith("dvae.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(x, before[k]), k


def test_ema_update_is_the_two_rounded_products():
    """``ema_update`` gives k * m + q * (1 - m) with each product rounded to
    f32, bit for bit, for every parameter and no buffer."""
    cfg = ConfigDict(dict(bert_model_cfg()))
    k, q = MaskTransformer(cfg), MaskTransformer(cfg)
    gen = torch.Generator().manual_seed(3)
    for mod in (k, q):
        for p in mod.parameters():
            p.data = torch.randn(p.shape, generator=gen)
    old = {n: p.detach().clone() for n, p in k.named_parameters()}
    ema_update(k, q, 0.999)
    for n, p in k.named_parameters():
        want = old[n].numpy() * np.float32(0.999) + \
            dict(q.named_parameters())[n].detach().numpy() * np.float32(1.0 - 0.999)
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=n)


# ---------------------------------------------------------------------------
# (c) the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_bridge_from_jax_params_round_trips(bert, scan):
    """``pointbert_state_dict`` from unrolled and scanned JAX stacks: every key
    is the port's with its shape, the port's keys it lacks are exactly the
    tokenizer tensors JAX never creates (``JAX_NEVER``), and the rules of
    ``torch_convert`` give back the unrolled flax tree and the buffers."""
    pts, cfg, v = bert
    if scan:
        cfg = bert_model_cfg(scan=True)
        v = jax_vars(JBERT(cfg), np.random.default_rng(1), pts)
    sd = weights.pointbert_state_dict(v["params"], v["batch_stats"], v["buffers"])
    own = ACT_PointBERT(ConfigDict(dict(cfg))).state_dict()
    assert all(tuple(own[k].shape) == tuple(x.shape) for k, x in sd.items())
    assert sd["queue_ptr"].dtype == torch.long and tuple(sd["queue_ptr"].shape) == (1,)
    lacking = sorted(set(own) - set(sd))
    assert lacking and all(k.startswith(JAX_NEVER) for k in lacking)
    assert {p for p in JAX_NEVER if any(k.startswith(p) for k in lacking)} == set(JAX_NEVER)
    np_sd = {k: x.numpy() for k, x in sd.items()}
    params, bs = tc.convert_state_dict(np_sd, tc.act_pointbert_rules())
    unrolled = jax.eval_shape(lambda p: JBERT(bert_model_cfg(scan=False)).init(RNGS, p),
                              jnp.asarray(pts))
    want_p = jckpt.flatten_keys(jckpt.adapt_block_layout(v["params"], unrolled["params"]))
    got_p = jckpt.flatten_keys(params)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    got_bs, want_bs = jckpt.flatten_keys(bs), jckpt.flatten_keys(v["batch_stats"])
    assert sorted(got_bs) == sorted(want_bs)
    buf = tc.pointbert_buffers(np_sd)
    np.testing.assert_array_equal(buf["queue"], np.asarray(v["buffers"]["queue"]))
    assert int(buf["queue_ptr"]) == int(v["buffers"]["queue_ptr"])


def test_reference_layout_loads_strictly():
    """A reference ACT_PointBERT state dict (the torch rebuild of
    ``tests/test_torch_fullgraph.py``: both trunks, the whole dVAE, the queue
    (cls_dim, K) and its (1,) int64 pointer) loads through
    ``build_pretrain_model`` with strict=True once its FoldingNet
    ``dvae.decoder.*`` keys are dropped; the queue comes with it."""
    torch.manual_seed(0)
    ref = TorchPointBERT()
    with torch.no_grad():
        ref.queue.normal_()
        ref.queue_ptr.fill_(3)
    sd = ref.state_dict()
    assert any(k.startswith("dvae.decoder.") for k in sd)
    model = runner.build_pretrain_model(tiny_pointbert_cfg(), state_dict=sd)
    assert torch.equal(model.queue, sd["queue"]) and int(model.queue_ptr) == 3
    assert torch.equal(model.transformer_k.lm_head.weight, sd["transformer_k.lm_head.weight"])


# ---------------------------------------------------------------------------
# (d) forward_eval and the features path
# ---------------------------------------------------------------------------

def test_features_of_both_pretrain_models_match_jax(bert):
    """``apply(noaug=True)`` of the JAX ACT_PointBERT and ACT_PointDistillation
    against the port's ``forward_eval`` (through ``build_features_fn``) on the
    same weights, within 1e-5; a cloud of 200 points is resampled to 128 by
    FPS first, as ``export_features`` does."""
    pts, cfg, v = bert
    model = port_bert(cfg, v).eval()
    want = japply(JBERT(cfg), v, pts, noaug=True, rngs=RNGS)
    got = build_features_fn(model, NPTS)(pts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert torch.equal(got, model(t(pts), noaug=True))

    rng = np.random.default_rng(2)
    dcfg = graft._pretrain_cfg(tiny=True)
    dcfg.transformer_config.drop_path_rate = 0.0
    jd = JDistill(dcfg)
    big = rng.normal(size=(2, 200, 3)).astype(np.float32)
    dv = jax_vars(jd, rng, pts)
    resampled = np.asarray(ops.gather_points(t(big), ops.furthest_point_sample(t(big), NPTS)))
    want = japply(jd, dv, resampled, noaug=True, rngs=RNGS)
    dmodel = ACT_PointDistillation(ConfigDict(dict(dcfg))).eval()
    dmodel.load_state_dict(weights.distillation_state_dict(dv["params"], dv["batch_stats"]),
                           strict=True)
    got = build_features_fn(dmodel, NPTS)(big)
    assert tuple(got.shape) == (2, int(dcfg.transformer_config.cls_dim))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_serve_http_features_kind(rng):
    """A pretrain config serves the features kind: the answer equals the
    direct call (a 200-point cloud resampled to the val split's 128), and a
    malformed or non-finite cloud gets 400."""
    cfg = train_cfg(bert_model_cfg())
    cfg.dataset = ConfigDict(dict(val=probe_node("test")))
    srv = serve_http.serve(cfg, host="127.0.0.1", port=0, device="cpu", seed=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        pts = rng.normal(size=(2, 200, 3)).astype(np.float32)
        code, resp = request(srv, "/predict", {"points": pts.tolist()})
        assert code == 200 and list(resp) == ["features"]
        model = runner.build_pretrain_model(cfg.model, 0).eval()
        want = build_features_fn(model, NPTS)(pts)
        np.testing.assert_allclose(np.asarray(resp["features"]), want.numpy(), rtol=0,
                                   atol=1e-6)
        code, health = request(srv, "/healthz")
        assert code == 200 and health["kind"] == "features" and health["npoints"] == NPTS
        assert health["model"] == "ACT_PointBERT" and health["cls_dim"] == 32
        bad = pts.copy()
        bad[0, 5, 1] = np.inf
        for payload in ({"points": bad.tolist()}, {"points": pts[0].tolist()}):
            code, resp = request(srv, "/predict", payload)
            assert code == 400 and "error" in resp
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


# ---------------------------------------------------------------------------
# (e) the runners on the CPU, the queue check, token replacement
# ---------------------------------------------------------------------------

def test_run_steps_on_cpu():
    """Seeded weights start with k equal to q; two steps give finite losses,
    move q by AdamW and k by the EMA only, and advance the queue by B a step;
    the tokenizer's parameters stay as they were (warm-up of one step, so
    that the second step's lr of 1e-3 moves k visibly)."""
    cfg = train_cfg(warmup_epochs=0)
    fresh = runner.build_pretrain_model(cfg.model, 0)
    q0 = dict(fresh.transformer_q.named_parameters())
    for n, p in fresh.transformer_k.named_parameters():
        assert torch.equal(p, q0[n]), n
    run = runner.run_steps(cfg, 2, device="cpu")
    assert len(run.losses) == 2 and all(math.isfinite(x) for x in run.losses)
    model = run.model
    assert int(model.queue_ptr) == 2 * BS % int(cfg.model.K)
    after, before = model.state_dict(), fresh.state_dict()
    for name in ("transformer_q.blocks.blocks.0.attn.qkv.weight",
                 "transformer_k.blocks.blocks.0.attn.qkv.weight", "transformer_q.lm_head.weight"):
        assert not torch.equal(after[name], before[name]), name
    k_moved = (after["transformer_k.lm_head.weight"] - before["transformer_k.lm_head.weight"])
    q_moved = (after["transformer_q.lm_head.weight"] - before["transformer_q.lm_head.weight"])
    assert 0 < float(k_moved.abs().max()) < 0.01 * float(q_moved.abs().max())
    for k, x in after.items():
        if k.startswith("dvae.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(x, before[k].to(x.dtype)), k
    assert after["dvae.encoder.first_conv.0.weight"].dtype == torch.bfloat16
    assert after["transformer_k.encoder.first_conv.0.weight"].dtype == torch.float32


def test_queue_needs_k_a_multiple_of_the_batch():
    model = runner.build_pretrain_model(bert_model_cfg(), 0)
    gens = {name: torch.Generator() for name in STREAMS}
    with pytest.raises(ValueError, match="multiple"):
        model(torch.randn(3, NPTS, 3), rngs=gens)


def test_run_net_resumes_to_the_same_queue_and_weights(tmp_path):
    """Two steps of ``run_net`` with the SVM probe (through ``forward_eval``),
    then a resume of ckpt-last: the weights, the queue and its pointer are
    bit-equal to the trained model's."""
    model_cfg = bert_model_cfg()
    cfg = ConfigDict(dict(train_cfg(model_cfg)))
    cfg.dataset = ConfigDict(dict(train=shapenet_node("train"), val=probe_node("test"),
                                  extra_train=probe_node("train")))
    cfg.max_epoch = 300
    path = str(tmp_path)
    res = runner.run_net(cfg, device="cpu", epochs=1, max_steps=2, experiment_path=path,
                         allow_random_tokenizer=True)
    assert res.step == 2 and len(res.probes) == 1 and math.isfinite(res.probes[0].acc)
    assert int(res.model.queue_ptr) == 2 * BS % int(model_cfg.K)
    again = runner.run_net(cfg, device="cpu", epochs=1, resume=True, experiment_path=path,
                           allow_random_tokenizer=True)
    assert again.step == 2 and not again.epoch_loss
    want = res.model.state_dict()
    got = again.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert torch.equal(got[k], x), k
    assert not torch.equal(got["queue"], runner.build_pretrain_model(model_cfg, 0).queue)


def test_random_replace_keeps_masked_rows_and_swaps_in_batch_rows():
    """``replace_pob > 0``: the overall mask holds the mask; each replaced
    token is a row of the batch's detached tokens and takes no gradient;
    every other token is unchanged."""
    cfg = bert_model_cfg()
    cfg.transformer_config.replace_pob = 0.5
    mt = MaskTransformer(ConfigDict(dict(cfg)))
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randn(BS, 16, 32, generator=gen, requires_grad=True)
    mask = torch.rand(BS, 16, generator=gen) < 0.3
    out, overall = mt.random_replace(tokens, mask, False, {"mask": gen})
    replaced = overall & ~mask
    assert torch.equal(overall & mask, mask) and replaced.any()
    rows = tokens.detach().reshape(-1, 32)
    for b, g in replaced.nonzero().tolist():
        assert (rows == out[b, g].detach()).all(-1).any()
    assert torch.equal(out[~replaced], tokens[~replaced])
    out.sum().backward()
    assert not tokens.grad[replaced].any() and (tokens.grad[~replaced] == 1).all()
    same, _ = mt.random_replace(tokens, mask, True, None)
    assert same is tokens


def test_token_all_mask_transformer_has_no_reduce_dim():
    cfg = ConfigDict(dict(bert_model_cfg()))
    mt = TokenAllMaskTransformer(cfg)
    assert isinstance(mt.reduce_dim, torch.nn.Identity)
    assert not any(k.startswith("reduce_dim.") for k in mt.state_dict())
    with torch.no_grad():
        nbr, ctr = ops.group_points(torch.randn(2, NPTS, 3), 16, 8)
        cls, logits, mask = mt.eval()(nbr, ctr, noaug=True)
    assert tuple(cls.shape) == (2, 32) and tuple(logits.shape) == (2, 16, 64)
    assert not mask.any()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_steps(train_cfg(), 1)
