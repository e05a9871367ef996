"""FPS on clouds above 16384 points, and ``transformer_config.remat``, held
against the JAX package on the CPU.

- the port's FPS (its plain version: these tensors lie on the CPU) against
  ``act_tpu.ops.furthest_point_sample`` (its XLA reference on the CPU) at
  (2, 40000) -> 256 from index 0 and (1, 70000) -> 64 from a drawn start:
  the picks equal up to counted adjacent tie swaps, the same set;
- ``launch_geometry`` above 16384 points with a card's cluster room faked:
  the slices cover the cloud, clusters of at most 16 blocks of at most 1024
  threads, shared memory within 227 KB, the streamed body past what a
  cluster holds; at most 16384 points the geometries of the registers body
  as they were;
- the 8k serving forward (``finetune_modelnet_8k.yaml``'s model narrowed as
  ``tests/test_torch_port_modelnet8k.py`` narrows it) on (2, 40000, 3)
  clouds resampled to 1024 against JAX's ``export.build_infer_fn``: the
  picks up to tie swaps, the logits within 1e-4;
- ``native.fps`` on (2, 20000) clouds equal to JAX's C++ ``native.fps``;
- a Stage-II step at smoke width with drop path 0.1 and ``remat: true``:
  equal bit for bit to the port's step without ``remat`` (loss, every
  gradient, the updated state), and against JAX's ``nn.remat`` step (the
  mask, the Gumbel draws and the drop-path keeps pinned on both sides) under
  ``tests/test_torch_port_train.py``'s tolerances: loss and BatchNorm
  statistics within 1e-5, gradients within 1e-4 of each tensor's largest.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu import native as jnative
from act_tpu import ops as jops
from act_tpu.engine import export as jexport
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.models import ACT_PointDistillation as JDistill
from act_tpu.models import common as jcommon

from act_tpu_torch import native, ops
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine.serve import build_infer_fn
from act_tpu_torch.engine.train_state import STREAMS, pretrain_step
from act_tpu_torch.models import ACT_PointDistillation, act, common
from act_tpu_torch.ops import fps as fps_mod
from act_tpu_torch.ops.fps import tie_swaps

from tests.test_torch_port_finetune import Pins, centre_head, jax_model, port_model
from tests.test_torch_port_modelnet8k import CLS, EVAL_ATOL, model_cfg
from tests.test_torch_port_stage2 import jax_variables
from tests.test_torch_port_train import ATOL, flat_np, to_flax, train_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

SMS = 132  # an H100 SXM's SMs


def h100_clusters(N, c, threads, ppt, streamed=False):
    """A fake room for clusters: as many as fit an H100 of 132 SMs when each
    block fills a whole SM (66, 30, 14 and 7 clusters of 2, 4, 8 and 16
    blocks). It is not what the card's ``cudaOccupancyMaxActiveClusters``
    reports for the registers body (blocks that share an SM: 66, 92, 92 and
    58 at 16385 points), so the pins below hold the Python rule, not the
    geometry the card launches."""
    return {1: 132, 2: 66, 4: 30, 8: 14, 16: 7}[c]


def roomy(N, c, threads, ppt, streamed=False):
    return 1000


@pytest.mark.parametrize("B,N,S,drawn", [(2, 40000, 256, False), (1, 70000, 64, True)])
def test_fps_above_16384_points_matches_jax(B, N, S, drawn):
    rng = np.random.default_rng(N)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    start = rng.integers(0, N, B).astype(np.int32) if drawn else None
    want = torch.from_numpy(np.array(jops.furthest_point_sample(
        jnp.asarray(pts), S, None if start is None else jnp.asarray(start))))
    got = ops.furthest_point_sample(torch.from_numpy(pts), S,
                                    None if start is None else torch.from_numpy(start))
    assert got.shape == (B, S) and got.dtype == torch.int32
    assert tie_swaps(got, want) >= 0
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)
    assert got[:, 0].tolist() == ([0] * B if start is None else start.tolist())


def test_fps_refuses_only_clouds_past_int32_indices():
    """No size limit below 2^31 points; from 2^31 the int32 indices would
    wrap (a meta tensor: nothing is allocated)."""
    with pytest.raises(ValueError, match="2\\^31"):
        ops.furthest_point_sample(torch.empty(1, 2 ** 31, 3, device="meta"), 4)
    assert not hasattr(fps_mod, "MAX_POINTS")


@pytest.mark.parametrize("N", [16385, 131072, 262144, 1 << 20])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 32, 200])
def test_fps_launch_geometry_above_16384_points(B, N):
    for room in (h100_clusters, roomy):
        c, threads, ppt = fps_mod.launch_geometry(B, N, SMS, room)
        slice_ = -(-N // c)
        body = fps_mod.fps_body(N, c, threads)
        assert c in fps_mod.BIG_CLUSTERS and c <= 16
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert threads * ppt >= slice_ and c * threads * ppt >= N
        assert body == ("shared" if N <= 131072 else "streamed")
        records = 2 * c * (threads // 32) * fps_mod.REC_BYTES + 16
        smem = fps_mod.big_smem_bytes(c, threads, slice_) if body == "shared" else records
        assert smem <= 227 * 1024
        if body == "streamed":  # no cluster size holds the cloud in shared memory
            assert all(fps_mod.big_smem_bytes(k, 128, -(-N // k)) > 227 * 1024
                       for k in fps_mod.BIG_CLUSTERS)
            assert (c, threads) == (16, 1024)
    # the card runs no cluster of 16: 131072 points fit no smaller cluster's shared
    # memory, so the streamed body on clusters of 8
    no16 = lambda N, c, t, p, streamed=False: 0 if c == 16 else 30  # noqa: E731
    assert fps_mod.launch_geometry(4, 131072, SMS, no16) == (8, 1024, 16)
    assert fps_mod.fps_body(131072, 8, 1024) == "streamed"
    # clusters grow while all B fit the SMs and the card's room, else stay smaller
    assert fps_mod.launch_geometry(2, 40000, SMS, h100_clusters) == (16, 256, 10)
    assert fps_mod.launch_geometry(8, 40000, SMS, h100_clusters)[0] == 8
    assert fps_mod.launch_geometry(32, 16385, SMS, h100_clusters) == (2, 256, 33)


def test_fps_occupancy_queries_stay_few_whatever_the_cloud_sizes():
    """A server sent clouds of ever new sizes asks the card (and caches)
    about few launches: above 16384 points the query's N is that of the
    shared slice rounded up to ``QUERY_SLICE`` points, or one N a geometry
    for the streamed body; each query keeps the body, C and threads, and its
    block at least the launch's shared memory."""
    asked = set()

    def counting(*args):
        asked.add(args)
        return h100_clusters(*args)

    sizes = range(16385, 1 << 20, 37)
    for N in sizes:
        geo = fps_mod.launch_geometry(1 + N % 16, N, SMS, counting)
        n, c, threads, ppt, streamed = fps_mod.query_args(N, *geo)
        assert (c, threads) == geo[:2] and n > fps_mod.REGISTER_POINTS
        assert streamed == (fps_mod.fps_body(N, *geo[:2]) == "streamed")
        assert threads * ppt >= -(-n // c)
        if not streamed:
            slice_, query_slice = -(-N // c), -(-n // c)
            assert slice_ <= query_slice <= slice_ + fps_mod.QUERY_SLICE
            assert fps_mod.big_smem_bytes(c, threads, query_slice) <= fps_mod.SMEM_LIMIT
    per_c = fps_mod.SMEM_LIMIT // (16 * fps_mod.QUERY_SLICE) + 2
    assert len(sizes) > 25000
    assert len(asked) <= len(fps_mod.BIG_CLUSTERS) * per_c
    assert len({a for a in asked if a[4]}) <= len(fps_mod.BIG_CLUSTERS)
    assert fps_mod.query_args(8192, 4, 256, 8) == (8192, 4, 256, 8)


# launch_geometry of the registers body as it was before the shared and streamed
# bodies: (B, N) -> (C, threads, points a thread) under an H100's cluster room
REGISTER_GEOMETRIES = {
    (1, 8192): (8, 128, 8), (32, 8192): (2, 256, 16), (64, 8192): (2, 256, 16),
    (128, 1024): (1, 128, 8), (1, 16384): (8, 256, 8), (8, 16384): (8, 256, 8),
    (32, 1024): (1, 128, 8), (2, 777): (1, 128, 8), (256, 8192): (1, 512, 16),
    (16, 2048): (2, 128, 8), (1, 20): (1, 32, 1), (4, 10000): (8, 160, 8)}


@pytest.mark.parametrize("B,N", sorted(REGISTER_GEOMETRIES))
def test_fps_launch_geometry_up_to_16384_points_is_unchanged(B, N):
    geo = fps_mod.launch_geometry(B, N, SMS, h100_clusters)
    assert geo == REGISTER_GEOMETRIES[B, N]
    assert fps_mod.fps_body(N, geo[0], geo[1]) == "registers"


def test_8k_serving_forward_on_40000_point_clouds_matches_jax(monkeypatch):
    """``build_infer_fn`` resampling (2, 40000, 3) clouds to 1024 points
    against JAX's ``export.build_infer_fn`` (``export.py:59``), the port's
    picks read from its one call."""
    from act_tpu_torch.engine import serve
    rng = np.random.default_rng(4)
    pins = Pins(monkeypatch)
    cfg = model_cfg()
    jm, v = jax_model(cfg, rng)
    pts = (rng.normal(size=(2, 40000, 3))
           + rng.normal(scale=3.0, size=(2, 1, 3))).astype(np.float32)
    picks_want = np.asarray(jax.jit(lambda p: jops.furthest_point_sample(p, 1024))(pts))
    v = centre_head(cfg, v, np.take_along_axis(pts, picks_want[..., None], 1), pins)
    want = np.asarray(jax.jit(lambda v, p: jexport.build_infer_fn(jm, v, 1024)(p))(
        v, jnp.asarray(pts)))
    seen = []
    fps = serve.furthest_point_sample
    monkeypatch.setattr(serve, "furthest_point_sample",
                        lambda p, n: seen.append(fps(p, n)) or seen[-1])
    got = build_infer_fn(port_model(cfg, v).eval(), 1024)(torch.from_numpy(pts))
    assert tie_swaps(seen[0], torch.from_numpy(picks_want)) >= 0
    assert got.shape == (2, CLS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EVAL_ATOL)


def test_native_fps_on_20000_point_clouds_equals_the_cpp():
    pts = np.random.default_rng(5).normal(size=(2, 20000, 3)).astype(np.float32)
    got = native.fps(pts, 2048, device="cpu")
    assert got.dtype == np.int64 and got.shape == (2, 2048)
    np.testing.assert_array_equal(got, jnative.fps(pts, 2048))


# ---------------------------------------------------------------------------
# transformer_config.remat
# ---------------------------------------------------------------------------

def remat_cfg(remat):
    cfg = train_cfg(drop_path=0.1)
    cfg.model.transformer_config.remat = remat
    return cfg


def port_step(cfg, state, patch=None):
    """One port Stage-II step from ``state`` with seeded generators; returns
    (loss, gradients, the state after the step)."""
    model = ACT_PointDistillation(cfg.model)
    model.load_state_dict(state, strict=True)
    builder.freeze(model, ["dvae_tokenizer"])
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    pts = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 128, 3)).astype(np.float32))
    gens = {name: torch.Generator().manual_seed(20 + i) for i, name in enumerate(STREAMS)}
    loss = pretrain_step(model, opt, schedule, pts, 0, gens, transform=None)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    return float(loss), grads, model.state_dict()


def test_remat_step_equals_the_step_without_it(monkeypatch):
    """The rematted student draws each block's drop-path uniforms before the
    checkpointed call: the recompute keeps them, so the loss, every gradient
    and the state after the step equal the unrematted step's bit for bit."""
    model = ACT_PointDistillation(remat_cfg(False).model)
    model.init_weights(torch.Generator().manual_seed(3))
    state = model.state_dict()
    assert not model.ACT_encoder.blocks.remat
    assert ACT_PointDistillation(remat_cfg(True).model).ACT_encoder.blocks.remat
    calls = []
    real = common.checkpoint
    monkeypatch.setattr(common, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    loss_r, grads_r, after_r = port_step(remat_cfg(True), state)
    assert len(calls) == remat_cfg(True).model.transformer_config.depth
    loss, grads, after = port_step(remat_cfg(False), state)
    assert len(calls) == remat_cfg(True).model.transformer_config.depth
    assert loss_r == loss
    assert sorted(grads_r) == sorted(grads)
    for k, g in grads.items():
        assert torch.equal(grads_r[k], g), k
    for k, x in after.items():
        assert torch.equal(after_r[k], x), k


def test_remat_step_matches_jax_nn_remat(rng, monkeypatch):
    pins = Pins(monkeypatch)
    monkeypatch.setattr(jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)

    def t_draw(self, x, rngs=None):  # the port's pre-drawn uniforms: 0 keeps, 1 drops
        if not self.training or self.rate == 0.0:
            return None
        keep = pins.mask("droppath", (x.shape[0],) + (1,) * (x.dim() - 1), 1.0 - self.rate)
        return torch.from_numpy(np.where(keep, 0.0, 1.0).astype(np.float32))
    monkeypatch.setattr(common.DropPath, "draw", t_draw)

    cfg = remat_cfg(True)
    jm = JDistill(cfg.model)
    pts = rng.normal(size=(4, 128, 3)).astype(np.float32)
    v = jax_variables(jm, rng, pts)
    params, stats = v["params"], v["batch_stats"]
    rngs = jax_step_rngs(jax.random.PRNGKey(7), jnp.int32(0))
    rngs.pop("augment")
    pins.reset()
    (j_loss, aux), j_grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p, "batch_stats": stats}, jnp.asarray(pts), train=True, rngs=rngs,
        mutable=["batch_stats", "intermediates"]), has_aux=True))(params)
    n_drops = pins.calls["droppath"]
    depth = cfg.model.transformer_config.depth
    decoder = cfg.model.transformer_config.decoder_depth
    assert n_drops == 2 * (depth - 1) + 2 * (decoder - 1)  # block 0 of each has rate 0
    inter = aux["intermediates"]
    mask = torch.from_numpy(np.array(inter["mask"][0]))
    u = torch.from_numpy(np.array(inter["dvae_tokenizer"]["gumbel_u"][0]))

    model = ACT_PointDistillation(cfg.model)
    model.load_state_dict(weights.distillation_state_dict(params, stats), strict=True)
    builder.freeze(model, ["dvae_tokenizer"])
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    monkeypatch.setattr(act, "random_mask", lambda g, B, G, n: mask)
    monkeypatch.setattr(ops, "gumbel_argmax", lambda logits, seed: torch.argmax(
        logits - torch.log(-torch.log(u)), dim=-1))
    pins.reset()
    gens = {name: torch.Generator() for name in STREAMS}
    loss = pretrain_step(model, opt, schedule, torch.from_numpy(pts), 0, gens, transform=None)
    assert pins.calls["droppath"] == n_drops
    np.testing.assert_allclose(float(loss), float(j_loss), atol=ATOL)

    got_g, _ = to_flax({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    want_g = {k: g for k, g in flat_np(j_grads).items() if not k.startswith("dvae_tokenizer")}
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    unused = {k for k in want_g if ".cls_head." in k}
    for k in unused:  # exactly zero on both sides
        assert not want_g[k].any() and not got_g[k].any(), k
    # zero up to rounding in JAX: a bias that a batch-statistics BatchNorm cancels
    noise = {k for k, g in want_g.items()
             if k not in unused and np.abs(g).max() < 1e-6 * g_max}
    assert noise == {"ACT_encoder.encoder.conv2.bias"}
    for k, g in got_g.items():
        if k not in noise:
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)
    _, got_bs = to_flax({k: x for k, x in model.state_dict().items() if "running" in k})
    want_bs = flat_np(aux["batch_stats"])
    assert sorted(got_bs) == sorted(want_bs)
    for k, x in got_bs.items():
        np.testing.assert_allclose(x, want_bs[k], rtol=0, atol=ATOL, err_msg=k)
