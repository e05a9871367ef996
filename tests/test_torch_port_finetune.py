"""The port's finetune model and train step held against the JAX package on the CPU.

A small PointTransformer (depth 2, width 32, 4 heads, 16 groups of 8 points,
256-point clouds) runs the same weights in both packages: JAX parameters are
drawn, perturbed and carried over by ``engine/weights.py``
``flax_to_state_dict``. The head's flax ``nn.Dropout`` and the drop paths
draw bits torch cannot reproduce, so the tests pin both sides to the same
numpy masks, handed out in call order (``Pins``). Tolerances:

- ``fps_subsample`` with the subset pinned: exact (index arithmetic and
  gathers only);
- ``rotate_y`` with the angles pinned: 1e-6 (one 3x3 product a point);
- train-mode logits: atol 1e-5 for every head (measured 5.4e-6); the new
  BatchNorm running statistics within 1e-5, absolute and relative. The
  clouds are shifted apart (``clouds``) and the mlp-3 head's BatchNorm
  inputs centred by its fc1 and fc2 biases (``centre_head``, which leaves
  the logits as they were): on random weights the head's features vary
  across a batch of centred clouds by ~1/50 of their mean, and flax's
  E[x^2] - E[x]^2 variance then turns 1e-7 rounding differences (sum order
  only) into 1.5e-4 of the logits;
- one f32 train step (transform pinned, drop path 0.3 pinned, the clip on
  the path), for the linear head and for the mlp-3 head: loss and accuracy
  within 1e-5; gradients (after the clip, applied to the JAX gradients as
  optax does) within 1e-5 of each tensor's largest gradient (measured 1.5e-6
  through the linear head, 4.3e-6 through the mlp-3 head), except the
  biases whose gradient the mean of a batch-statistics BatchNorm cancels
  (``CANCELLED``), zero up to rounding on both sides (below 1e-4 of the
  largest gradient); updated parameters and statistics within 1e-5, and
  each parameter's step within 2 ulp + 1e-3 of JAX's wherever |g| is above
  twice the gradient tolerance and 1e-6 (below that Adam's normalised step
  turns rounding-level gradient differences into steps of either sign).
  The step's seed has every max-pool choice clear by ``MARGIN`` of the
  pooled tensor's scale, checked first: a closer call lets 1-ulp
  differences route a gradient to the other candidate.
"""
import math

import flax.linen as fnn
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.datasets import transforms as jT
from act_tpu.engine import builder as jbuilder
from act_tpu.engine.train_state import TrainState, apply_bn_ratio, make_finetune_step
from act_tpu.models import common as jcommon
from act_tpu.models.point_transformer import PointTransformer as JPointTransformer
from act_tpu.models.point_transformer import get_loss_acc as j_get_loss_acc
from act_tpu.models.point_transformer import trainable_mask as j_trainable_mask
from act_tpu.ops import group as jgroup
from act_tpu.utils.config import ConfigDict as JConfigDict
from act_tpu.utils.misc import bn_update_ratio

from act_tpu_torch import ops
from act_tpu_torch.datasets.transforms import rotate_y, rotate_y_by
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine.train_state import STREAMS, finetune_step
from act_tpu_torch.models import MODELS, common
from act_tpu_torch.models.point_transformer import get_loss_acc
from act_tpu_torch.ops.group import subset_draw
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_model import RNGS, perturb

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

TRANSFERS = ("full", "linear", "mlp-3", "side", "bit-fit")
ATOL = 1e-5
N_PTS, B, CLS = 256, 4, 10
STEP_SEED = 3  # a batch whose max-pool choices are all clear by MARGIN
MARGIN = 5e-7
# biases whose gradient the mean of a batch-statistics BatchNorm cancels: the
# group encoder's conv2 (before conv3's BatchNorm), and with the mlp-3 head
# the final norm's bias and the head's fc1 and fc2 biases (before its two)
CANCELLED = {"encoder.first_conv.3.bias", "norm.bias", "cls_head_finetune.0.bias",
             "cls_head_finetune.4.bias"}


def tiny_cfg(transfer="full", drop_path=0.0):
    return dict(NAME="PointTransformer", embed_dim=32, depth=2, drop_path_rate=drop_path,
                cls_dim=CLS, num_heads=4, group_size=8, num_group=16, encoder_dims=32,
                transfer_type=transfer, scan=False)


def train_cfg(model_cfg):
    return ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        grad_norm_clip=10, total_bs=B, npoints=N_PTS, model=model_cfg))


def jax_model(model_cfg, rng):
    jm = JPointTransformer(JConfigDict(model_cfg))
    v = jax.jit(lambda: jm.init(RNGS, jnp.zeros((2, N_PTS, 3))))()
    return jm, {k: perturb(x, rng) for k, x in jax.device_get(v).items()}


def port_model(model_cfg, v):
    model = MODELS.build(ConfigDict(model_cfg))
    model.load_state_dict(weights.flax_to_state_dict(v["params"], v["batch_stats"]),
                          strict=True)
    return model


def as_port(tree, stats):
    """A flax params-shaped tree (gradients, masks) in the port's layout."""
    return weights.flax_to_state_dict(jax.device_get(tree), stats)


class Pins:
    """Keep-masks for the drop paths and dropouts of one forward, the same on
    both sides: call i of a kind gets the mask drawn from (kind, i)."""

    def __init__(self, monkeypatch):
        self.reset()
        pins = self

        def j_droppath(self, x, deterministic, rate_override=None):
            if deterministic or self.rate == 0.0:
                return x
            keep = 1.0 - self.rate
            m = pins.mask("droppath", (x.shape[0],) + (1,) * (x.ndim - 1), keep)
            return jnp.where(m, x / jnp.asarray(keep, x.dtype), jnp.zeros([], x.dtype))

        def j_dropout(self, inputs, deterministic=None, rng=None):
            det = self.deterministic if deterministic is None else deterministic
            if self.rate == 0.0 or det:
                return inputs
            keep = 1.0 - self.rate
            return jnp.where(pins.mask("dropout", inputs.shape, keep), inputs / keep,
                             jnp.zeros_like(inputs))

        def t_droppath(self, x, rngs=None):
            if not self.training or self.rate == 0.0:
                return x
            keep = 1.0 - self.rate
            m = torch.from_numpy(pins.mask("droppath", (x.shape[0],) + (1,) * (x.dim() - 1),
                                           keep))
            return torch.where(m, x / common.scalar(keep, x), common.scalar(0.0, x))

        def t_dropout(self, x, rngs=None):
            if not self.training or self.rate == 0.0:
                return x
            m = torch.from_numpy(pins.mask("dropout", tuple(x.shape), 1.0 - self.rate))
            return torch.where(m, x / common.scalar(1.0 - self.rate, x), common.scalar(0.0, x))

        monkeypatch.setattr(jcommon.DropPath, "__call__", j_droppath)
        monkeypatch.setattr(fnn.Dropout, "__call__", j_dropout)
        monkeypatch.setattr(common.DropPath, "forward", t_droppath)
        monkeypatch.setattr(common.Dropout, "forward", t_dropout)

    def reset(self):
        self.calls = {"droppath": 0, "dropout": 0}

    def mask(self, kind, shape, keep):
        i = self.calls[kind]
        self.calls[kind] += 1
        r = np.random.default_rng([11, 0 if kind == "droppath" else 1, i])
        return r.random(shape) < keep


def clouds(rng, n=B):
    """Normal clouds, each shifted by its own N(0, 3^2) offset: the shifted
    centres spread the head's features across the batch several times
    wider than centred clouds do."""
    pts = rng.normal(size=(n, N_PTS, 3)) + rng.normal(scale=3.0, size=(n, 1, 3))
    return pts.astype(np.float32)


def centre_head(model_cfg, v, pts, pins):
    """Set the mlp-3 head's fc1 and fc2 biases to minus the batch mean, in
    training mode with the pinned dropouts, of the BatchNorm input each
    feeds. A batch-statistics BatchNorm subtracts that mean, so the logits
    and every other gradient keep their values; what changes is that the
    E[x^2] - E[x]^2 variance of both packages no longer cancels a mean many
    times the batch spread (on random weights the head's features vary
    across clouds by ~1/50 of their mean, which would turn 1e-7 rounding
    differences of its inputs into 1e-4 of its outputs and gradients)."""
    head = v["params"]["cls_head_finetune"]
    for fc, bn in (("fc1", 1), ("fc2", 5)):
        seen = []
        model = port_model(model_cfg, v).train()
        model.cls_head_finetune[bn].register_forward_hook(
            lambda m, args, out: seen.append(args[0].detach()))
        pins.reset()
        model(torch.from_numpy(pts))
        head[fc]["bias"] = (head[fc]["bias"] - seen[0].mean(0).numpy()).astype(np.float32)
    return v


def j_train_apply(jm, v, pts, pins):
    pins.reset()
    return jax.jit(lambda v, p: jm.apply(v, p, train=True, mutable=["batch_stats"],
                                         rngs=dict(dropout=RNGS["dropout"],
                                                   droppath=RNGS["droppath"])))(v, pts)


# ---------------------------------------------------------------------------
# the augments
# ---------------------------------------------------------------------------

def jax_subsets(key, B_, n_fps, n_out):
    keys = jax.random.split(key, B_)
    return np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n_fps)[:n_out])(keys))


@pytest.mark.parametrize("N,n_fps,n_out", [(300, 200, 128), (256, 256, 100), (256, 300, 256)])
def test_fps_subsample_matches_jax(rng, N, n_fps, n_out):
    """FPS then the pinned subset; n_fps >= N gathers the subset of the cloud
    itself (no FPS), as the JAX package does."""
    xyz = rng.normal(size=(3, N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jgroup.fps_subsample(jnp.asarray(xyz), n_fps, n_out, key))
    sub = jax_subsets(key, 3, min(n_fps, N), n_out)
    got = ops.fps_subsample_by(torch.from_numpy(xyz), n_fps,
                               torch.from_numpy(sub.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_subsample_draws_a_subset_of_the_fps_picks(rng):
    xyz = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32))
    got = ops.fps_subsample(xyz, 200, 128, torch.Generator().manual_seed(4))
    sub = subset_draw(2, 200, 128, torch.Generator().manual_seed(4), "cpu")
    assert sub.dtype == torch.int32 and sub.shape == (2, 128)
    assert all(len(set(row.tolist())) == 128 and max(row.tolist()) < 200 for row in sub)
    assert torch.equal(got, ops.fps_subsample_by(xyz, 200, sub))
    picks = ops.furthest_point_sample_ref(xyz, 200)
    assert torch.equal(got, ops.gather_points(xyz, picks.gather(1, sub.long())))


def test_index_compose_keeps_every_int32_bit():
    """The compose carries int32 picks through the coordinate gather as f32
    bits: denormals (indices below 2^23) and indices above 2^24 come back
    unchanged on the plain path."""
    picks = torch.tensor([[0, 1, 7, 8191, 2 ** 23 + 1, 2 ** 24 + 3, 2 ** 31 - 1]],
                         dtype=torch.int32)
    sub = torch.tensor([[6, 5, 4, 3, 2, 1, 0]], dtype=torch.int32)
    out = ops.gather_coords(picks.view(torch.float32)[:, :, None], sub)
    assert torch.equal(out[:, :, 0].view(torch.int32), picks.flip(-1))


def test_rotate_y_matches_jax(rng):
    pc = rng.normal(size=(3, 50, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jT.rotate_y(key, jnp.asarray(pc)))
    angle = np.asarray(jax.random.uniform(key, (3,)) * 2 * jnp.pi)
    got = rotate_y_by(torch.from_numpy(pc), torch.from_numpy(angle))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    out = rotate_y(torch.from_numpy(pc), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out[..., 1].numpy(), pc[..., 1])  # y stays
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), np.linalg.norm(pc, axis=-1),
                               rtol=1e-5)


def test_port_dropout_draw():
    """The port's own dropout: keep rate 1 - p, kept values scaled by 1/(1 - p),
    the same mask from the same generator."""
    d = common.Dropout(0.5).train()
    x = torch.rand(1000, 1000) + 1.0
    a = d(x, {"dropout": torch.Generator().manual_seed(1)})
    b = d(x, {"dropout": torch.Generator().manual_seed(1)})
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.equal(a[kept], x[kept] / 0.5)
    assert torch.equal(d.eval()(x), x)


# ---------------------------------------------------------------------------
# the model in training mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transfer,drop_path", [(t, 0.0) for t in TRANSFERS]
                         + [("full", 0.3)])
def test_train_forward_matches_jax(rng, monkeypatch, transfer, drop_path):
    pins = Pins(monkeypatch)
    model_cfg = tiny_cfg(transfer, drop_path)
    jm, v = jax_model(model_cfg, rng)
    pts = clouds(rng)
    if transfer != "linear":
        v = centre_head(model_cfg, v, pts, pins)
    want, new = j_train_apply(jm, v, jnp.asarray(pts), pins)
    model = port_model(model_cfg, v).train()
    pins.reset()
    got = model(torch.from_numpy(pts))
    assert pins.calls == {"droppath": 2 if drop_path else 0,
                          "dropout": 0 if transfer == "linear" else 2}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    want_sd = as_port(v["params"], jax.device_get(new["batch_stats"]))
    for k, x in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(x.numpy(), want_sd[k].numpy(), rtol=ATOL, atol=ATOL,
                                       err_msg=k)
            assert not torch.equal(x, as_port(v["params"], v["batch_stats"])[k]), k


def test_train_mode_needs_its_generators(rng):
    model = MODELS.build(ConfigDict(tiny_cfg("full", 0.1))).train()
    with pytest.raises(ValueError, match="droppath"):
        model(torch.zeros(2, N_PTS, 3))
    model = MODELS.build(ConfigDict(tiny_cfg("mlp-3", 0.0))).train()
    with pytest.raises(ValueError, match="dropout"):
        model(torch.zeros(2, N_PTS, 3))
    pts = torch.from_numpy(rng.normal(size=(2, N_PTS, 3)).astype(np.float32))
    gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}
    assert model(pts, rngs=gens).shape == (2, CLS)


def test_get_loss_acc_matches_jax(rng):
    logits = rng.normal(size=(16, CLS)).astype(np.float32)
    labels = rng.integers(0, CLS, 16).astype(np.int32)
    labels[:4] = logits[:4].argmax(-1)
    wl, wa = j_get_loss_acc(jnp.asarray(logits), jnp.asarray(labels))
    gl, ga = get_loss_acc(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
    assert float(ga) == float(wa) and float(ga) >= 25.0


@pytest.mark.parametrize("transfer", TRANSFERS)
def test_trainable_sets_match_jax(transfer):
    """The port freezes exactly the tensors that JAX's path-substring rule
    freezes (the bridge maps each flax leaf to its port tensor; the group
    encoders' conv1/conv3 biases have no flax leaf and never train)."""
    model_cfg = tiny_cfg(transfer)
    jm = JPointTransformer(JConfigDict(model_cfg))
    v = jax.eval_shape(lambda: jm.init(RNGS, jnp.zeros((2, N_PTS, 3))))  # shapes only
    mask = j_trainable_mask(v["params"], transfer)
    marks = jax.tree_util.tree_map(lambda t, p: np.full(p.shape, float(t)), mask, v["params"])
    stats = jax.tree_util.tree_map(lambda p: np.zeros(p.shape), v["batch_stats"])
    want = {k: bool(x.all()) for k, x in as_port(marks, stats).items()
            if "running" not in k and "num_batches" not in k}
    model = MODELS.build(ConfigDict(model_cfg))
    builder.freeze_transfer(model, transfer)
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    assert got == want
    assert any(got.values()) and (transfer == "full" or not all(got.values()))
    if transfer in ("linear", "mlp-3"):
        assert got["cls_token"] and got["cls_pos"]


@pytest.mark.parametrize("transfer", TRANSFERS)
def test_step_moves_exactly_the_trainable_tensors(rng, transfer):
    """After one step the frozen parameters are unchanged bit for bit, every
    trainable one moved, and every BatchNorm's running statistics (frozen or
    not) updated, as in JAX, where they are mutable state."""
    model_cfg = tiny_cfg(transfer, 0.1)
    model = MODELS.build(ConfigDict(model_cfg))
    model.init_weights(torch.Generator().manual_seed(2))
    builder.freeze_transfer(model, transfer)
    opt, schedule = builder.build_optimizer(train_cfg(model_cfg), model, 4)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert all((id(p) in in_opt) == p.requires_grad for p in model.parameters())
    before = {k: x.clone() for k, x in model.state_dict().items()}
    pts = torch.from_numpy(rng.normal(size=(B, N_PTS, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLS, B))
    gens = {n: torch.Generator().manual_seed(1) for n in STREAMS}
    loss, acc = finetune_step(model, opt, schedule, pts, labels, 40, gens)
    assert math.isfinite(float(loss)) and 0.0 <= float(acc) <= 100.0
    after = model.state_dict()
    for n, p in model.named_parameters():
        assert torch.equal(after[n], before[n]) != p.requires_grad, n
    for k in after:
        if "running" in k:
            assert not torch.equal(after[k], before[k]), k


def test_bn_momentum_schedule_matches_apply_bn_ratio(rng):
    """A scheduled momentum set on the port's BatchNorms gives the running
    statistics that JAX's fixed-momentum update retargeted by apply_bn_ratio
    gives; the schedule itself is the JAX one, and absent without a node."""
    node = dict(type="Lambda", kwargs=dict(bn_momentum=0.9, bn_decay=0.5, decay_step=20,
                                           lowest_decay=0.01))
    want_s = jbuilder.build_bnm_schedule(JConfigDict(dict(bnmscheduler=node)))
    got_s = builder.build_bnm_schedule(ConfigDict(dict(bnmscheduler=node)))
    assert [got_s(e) for e in (0, 7, 20, 55, 300)] == [want_s(e) for e in (0, 7, 20, 55, 300)]
    assert builder.build_bnm_schedule(ConfigDict({})) is None
    model_cfg = tiny_cfg("linear")
    jm, v = jax_model(model_cfg, rng)
    pts = rng.normal(size=(B, N_PTS, 3)).astype(np.float32)
    _, new = jax.jit(lambda v, p: jm.apply(v, p, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(pts))
    m = got_s(30)
    stats = apply_bn_ratio(v["batch_stats"], jax.device_get(new["batch_stats"]),
                           bn_update_ratio(m))
    model = port_model(model_cfg, v).train()
    builder.set_bn_momentum(model, m)
    model(torch.from_numpy(pts))
    want = as_port(v["params"], jax.device_get(stats))
    for k, x in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(x.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# one f32 train step against make_finetune_step
# ---------------------------------------------------------------------------

def pool_margin(monkeypatch, fn):
    """Run ``fn`` recording every ``torch.amax`` over one axis; returns the
    smallest gap between a pooled maximum and the runner-up, relative to the
    pooled tensor's largest magnitude."""
    gaps = []
    amax = torch.amax

    def recording(x, dim, keepdim=False):
        top2 = x.detach().float().topk(2, dim=dim).values
        gap = (top2.select(dim, 0) - top2.select(dim, 1)).min()
        gaps.append(float(gap) / max(float(x.detach().abs().max()), 1e-30))
        return amax(x, dim=dim, keepdim=keepdim)
    monkeypatch.setattr(torch, "amax", recording)
    fn()
    monkeypatch.setattr(torch, "amax", amax)
    return min(gaps)


@pytest.mark.parametrize("head", ["linear", "mlp-3"])
def test_one_finetune_step_matches_make_finetune_step(monkeypatch, head):
    rng = np.random.default_rng(STEP_SEED)
    pins = Pins(monkeypatch)
    model_cfg = tiny_cfg("full" if head == "mlp-3" else "linear", 0.3)
    cfg = train_cfg(model_cfg)
    cfg.grad_norm_clip = 1.0  # below the step's gradient norm: the clip is on the path
    jm, v = jax_model(model_cfg, rng)
    params, stats = v["params"], v["batch_stats"]
    pts = clouds(rng)
    labels = rng.integers(0, CLS, B).astype(np.int32)
    if head == "mlp-3":
        v = centre_head(model_cfg, v, pts, pins)
        params = v["params"]
    model = port_model(model_cfg, v)
    gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}

    def forward():
        pins.reset()
        model.train()(torch.from_numpy(pts))
    assert pool_margin(monkeypatch, forward) >= MARGIN
    model.load_state_dict(as_port(params, stats))  # the forward moved the statistics

    # JAX: gradients, then the whole step
    base = jax.random.PRNGKey(7)

    def loss_fn(p):
        logits, new = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(pts),
                               train=True, mutable=["batch_stats"], rngs=RNGS)
        return j_get_loss_acc(logits, jnp.asarray(labels))[0]
    pins.reset()
    j_grads = jax.jit(jax.grad(loss_fn))(params)
    tx, _ = jbuilder.build_optimizer(cfg, params, 4, None)
    pins.reset()
    j_state, metrics = make_finetune_step(jm)(TrainState.create(v, tx), jnp.asarray(pts),
                                              jnp.asarray(labels), base)

    # port: the same step
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    pins.reset()
    loss, acc = finetune_step(model, opt, schedule, torch.from_numpy(pts),
                              torch.from_numpy(labels), 0, gens,
                              grad_norm_clip=cfg.grad_norm_clip)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=0, atol=ATOL)
    assert float(acc) == float(metrics["acc"])

    norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(j_grads))))
    clip = min(1.0, cfg.grad_norm_clip / norm)  # optax clip_by_global_norm
    assert clip < 1.0  # the clip is on the path
    want_g = {k: g * clip for k, g in as_port(j_grads, stats).items()}
    got_g = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    g_max = max(float(g.abs().max()) for g in want_g.values())
    noise = {k for k in got_g if float(want_g[k].abs().max()) < 1e-4 * g_max}
    assert "encoder.first_conv.3.bias" in noise and noise <= CANCELLED, noise
    for k, g in got_g.items():
        if k in noise:
            assert float(g.abs().max()) < 1e-4 * g_max, k
        else:
            np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), rtol=0,
                                       atol=ATOL * float(want_g[k].abs().max()), err_msg=k)

    after = model.state_dict()
    want_p = as_port(j_state.params, jax.device_get(j_state.batch_stats))
    for k, x in after.items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(x.numpy(), want_p[k].numpy(), rtol=0, atol=ATOL, err_msg=k)
        if k in got_g:
            d = (x - before[k]).double().numpy()
            want_d = (want_p[k] - before[k]).double().numpy()
            ulp = 2 * np.spacing(np.abs(before[k].numpy()))
            wg = np.abs(want_g[k].numpy())
            sure = (wg >= 1e-6) & (wg > 2 * ATOL * wg.max())
            assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
        elif "running" in k:
            assert not torch.equal(x, before[k]), k
