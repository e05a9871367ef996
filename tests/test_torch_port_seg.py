"""The port's segmentation ops, models, weight bridge and serving held against
the JAX package on the CPU.

The JAX tests' own sizes (``tests/test_segmentation.py``): B=2 clouds of 128
points, 16 groups of 8, the full 384 x 12 backbone. JAX runs on the CPU,
where its kNN is ``knn_ref``. JAX parameters are drawn, perturbed and
carried over by ``engine/weights.py`` ``seg_state_dict``. Tolerances:

- ``three_nn_interpolate``: values and the gradients to both coordinate
  arguments and to the features within 2e-6 of each tensor's largest
  magnitude (measured 7.6e-7; the sums run in another order);
  ``three_nn_interpolate_ref`` (on the CPU bit-equal to it: the same
  neighbours and ``nn_blend``) against JAX's, which blends by expanded-form
  distances, within 1e-4 (measured 4.8e-6 for the values and 2.6e-5 for
  the gradients; JAX's two forms differ from each other as much);
- eval log-probs in f32 within 1e-5 absolute (measured 1.9e-6); in bf16
  within 0.05 (measured 0.021: a bf16 rounding of a 1-ulp-different f32
  value lands one bf16 ulp apart), with the same argmax wherever JAX's top
  two are more than 0.1 apart;
- one f32 train step with the drop paths and the dropout pinned: the loss
  and the new BatchNorm statistics within 1e-5; the clipped gradients
  within 1e-4 of each tensor's largest (measured 1.7e-5; the batch is one
  whose group max-pools are clear by 1e-6 of their scale, checked first,
  since 1-ulp differences at a closer call route a gradient to the other
  candidate), label_conv's within 1e-4 of the model's largest gradient, and
  the biases that a batch-statistics BatchNorm cancels zero up to 1e-4 of
  it on both sides; AdamW's step (at the first step's lr) within 2 ulp + 1e-3 of
  JAX's wherever |g| exceeds 1e-3 of the tensor's largest.
"""
import copy
import functools
import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu import ops as jops
from act_tpu.engine.runner_segmentation import _make_state as j_make_state
from act_tpu.models.segmentation import PartSegTransformer as JPartSeg
from act_tpu.models.segmentation import SemSegTransformer as JSemSeg
from act_tpu.models.segmentation import nll_seg_loss as j_nll_seg_loss
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import ops, serve_http
from act_tpu_torch.engine import weights
from act_tpu_torch.engine.runner_segmentation import build_seg_state
from act_tpu_torch.engine.serve import build_infer_fn, load_seg_model
from act_tpu_torch.engine.train_state import seg_step
from act_tpu_torch.models import MODELS
from act_tpu_torch.models.segmentation import nll_seg_loss
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_fullgraph import TorchPartSeg, TorchSemSeg
from tests.test_torch_port_finetune import Pins
from tests.test_torch_port_model import RNGS, perturb

B, N, G, M = 2, 128, 16, 8
TASKS = {"partseg": (JPartSeg, 50), "semseg": (JSemSeg, 13)}
LABELS = [2, 9]
BF16_ATOL, BF16_MARGIN = 0.05, 0.1


def model_cfg(task, dtype=None):
    cfg = dict(NAME=TASKS[task][0].__name__, cls_dim=TASKS[task][1], num_group=G, group_size=M)
    if dtype:
        cfg["dtype"] = dtype
    return cfg


def inputs(task, seed=0):
    r = np.random.default_rng(seed)
    pts = r.normal(size=(B, N, 3)).astype(np.float32)
    return (pts, np.eye(16, dtype=np.float32)[LABELS]) if task == "partseg" else (pts,)


@functools.lru_cache(maxsize=None)
def jax_variables(task):
    """The JAX model's perturbed (params, batch_stats), drawn once a task."""
    jm = TASKS[task][0](JConfigDict(model_cfg(task)))
    v = jax.jit(lambda *x: jm.init(RNGS, *x))(*map(jnp.asarray, inputs(task)))
    return {k: perturb(x, np.random.default_rng(7)) for k, x in jax.device_get(v).items()}


def port_model(task, v, dtype=None):
    model = MODELS.build(ConfigDict(model_cfg(task, dtype)))
    model.load_state_dict(weights.seg_state_dict(v["params"], v["batch_stats"],
                                                 task == "partseg"), strict=True)
    return model.eval()


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# three_nn_interpolate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coincide", [False, True])
@pytest.mark.parametrize("which", ["three_nn_interpolate", "three_nn_interpolate_ref"])
def test_three_nn_interpolate_values_and_grads_match_jax(which, coincide):
    """The port's ``which`` against JAX's: values and the gradients to
    unknown_xyz, known_xyz and known_feats; with ``coincide`` every center is
    one of the queries (FPS centers are)."""
    r = np.random.default_rng(3)
    S, C = 16, 24
    u = r.normal(size=(B, N, 3)).astype(np.float32)
    k = u[:, 5:5 + S].copy() if coincide else r.normal(size=(B, S, 3)).astype(np.float32)
    f = r.normal(size=(B, S, C)).astype(np.float32)
    g = r.normal(size=(B, N, C)).astype(np.float32)
    want, vjp = jax.vjp(getattr(jops, which), *map(jnp.asarray, (u, k, f)))
    t = [torch.from_numpy(x).requires_grad_() for x in (u, k, f)]
    got = getattr(ops, which)(*t)
    got.backward(torch.from_numpy(g))
    tol = 2e-6 if which == "three_nn_interpolate" else 1e-4
    assert got.dtype == torch.float32 and got.shape == (B, N, C)
    assert rel_err(got.detach(), want) <= tol
    for x, w in zip(t, vjp(jnp.asarray(g))):
        assert rel_err(x.grad, w) <= tol


def test_three_nn_interpolate_blends_the_three_nearest():
    """A query on a center takes that center's features (weight 1/1e-8
    against ~1/d); the output keeps the features' dtype; on the CPU the
    neighbours come from the plain k-smallest, so the plain version gives
    the same tensor."""
    r = np.random.default_rng(4)
    known = torch.from_numpy(r.normal(size=(1, 8, 3)).astype(np.float32))
    feats = torch.from_numpy(r.normal(size=(1, 8, 5)).astype(np.float32))
    out = ops.three_nn_interpolate(known[:, [3, 6]], known, feats)
    torch.testing.assert_close(out, feats[:, [3, 6]], rtol=0, atol=1e-6)
    assert ops.three_nn_interpolate(known, known, feats.bfloat16()).dtype == torch.bfloat16
    queries = torch.from_numpy(r.normal(size=(1, 20, 3)).astype(np.float32))
    assert torch.equal(ops.three_nn_interpolate_ref(queries, known, feats),
                       ops.three_nn_interpolate(queries, known, feats))
    _, idx = ops.knn_ref(known, known[:, [3, 6]], 3)
    assert idx[0, :, 0].tolist() == [3, 6]


# ---------------------------------------------------------------------------
# the models, the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", list(TASKS))
def test_eval_log_probs_match_jax_f32_and_bf16(task):
    v = jax_variables(task)
    x = inputs(task)
    for dtype in (None, "bf16"):
        jm = TASKS[task][0](JConfigDict(model_cfg(task, dtype)))
        want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a))(v, *map(jnp.asarray, x)))
        with torch.no_grad():
            got = port_model(task, v, dtype)(*map(torch.from_numpy, x))
        assert got.dtype == torch.float32 and got.shape == (B, N, TASKS[task][1])
        got = got.numpy()
        if dtype is None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
            top2 = np.sort(want, -1)[..., -2:]
            clear = top2[..., 1] - top2[..., 0] > BF16_MARGIN
            assert clear.mean() > 0.5
            np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_seg_state_dict_takes_the_scanned_stack(monkeypatch):
    """A JAX model built with the scanned stack (ACT_TPU_SCAN) carries over
    to the same port model and gives the same log-probs."""
    monkeypatch.setenv("ACT_TPU_SCAN", "1")
    jm = JSemSeg(JConfigDict(model_cfg("semseg")))
    (pts,) = inputs("semseg", 1)
    v = jax.jit(lambda p: jm.init(RNGS, p))(jnp.asarray(pts))
    v = {k: perturb(x, np.random.default_rng(8)) for k, x in jax.device_get(v).items()}
    assert "blocks" in v["params"]["backbone"]["blocks"]  # the scanned layout
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p))(v, jnp.asarray(pts)))
    with torch.no_grad():
        got = port_model("semseg", v)(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("task", list(TASKS))
def test_reference_torch_layout_loads_strict(task):
    """The reference's state dict, ``_cls`` head keys and all, loads with
    strict=True through ``seg_reference_keys`` (``load_seg_model`` applies
    it), and the port's forward gives the reference model's log-probs (f32,
    within 1e-4: the reference interpolates with its own distance form)."""
    torch.manual_seed(17)
    ref = (TorchPartSeg() if task == "partseg" else TorchSemSeg()).eval()
    sd = ref.state_dict()
    assert any("_cls." in k for k in sd)
    model = load_seg_model(task, sd, num_group=G, dtype="f32", device="cpu")
    x = [torch.from_numpy(a) for a in inputs(task, 2)]
    with torch.no_grad():
        got = model(*x)
        nbr, center = ops.group_points_ref(x[0], G, model.group_size)
        want = ref(nbr, center, *x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    released = {k.replace("_cls", ""): v for k, v in sd.items()}
    assert weights.seg_reference_keys(sd).keys() == released.keys()


@pytest.mark.parametrize("weighted", [False, True])
def test_nll_seg_loss_matches_jax(weighted):
    r = np.random.default_rng(5)
    lp = np.log(r.dirichlet(np.ones(13), size=(2, 50))).astype(np.float32)
    tgt = r.integers(0, 13, size=(2, 50))
    w = r.uniform(0.5, 3.0, 13).astype(np.float32) if weighted else None
    want = j_nll_seg_loss(jnp.asarray(lp), jnp.asarray(tgt), None if w is None else jnp.asarray(w))
    got = nll_seg_loss(torch.from_numpy(lp), torch.from_numpy(tgt),
                       None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


STEP_SEED, STEP_B, MARGIN = 7, 2, 1e-6  # a batch whose group max-pools are clear by MARGIN
# biases whose gradient the mean of a batch-statistics BatchNorm cancels: each
# conv's before its BatchNorm, the group encoder's conv2 (before the max and
# conv3's BatchNorm) and the final norm's (it shifts every pooled and
# interpolated feature alike, before convs1's and the propagation's BatchNorms)
CANCELLED = {"encoder.first_conv.3.bias", "norm.bias", "propagation_0.mlp_convs.0.bias",
             "propagation_0.mlp_convs.1.bias", "convs1.bias", "convs2.bias"}


def group_max_margin(model, pts: torch.Tensor) -> float:
    """The smallest gap between the largest and the second largest entry of
    the group encoder's two max-pools, over the pooled tensor's largest
    magnitude, in training mode: a gap of a few ulp lets 1-ulp differences
    route a gradient to the other candidate. Runs on a copy (training mode
    updates the running statistics)."""
    enc = copy.deepcopy(model.encoder).train()
    nbr, _ = ops.group_points(pts, model.num_group, model.group_size)
    BG = nbr.shape[0] * nbr.shape[1]
    with torch.no_grad():
        x = enc.first_conv(nbr.reshape(BG, -1, 3))
        w = enc.second_conv[0].weight[..., 0]
        g = torch.amax(x, 1)
        y = x @ w[:, g.shape[-1]:].T + (g @ w[:, :g.shape[-1]].T)[:, None]
        y = enc.second_conv[1:](y + enc.second_conv[0].bias)

    def margin(t):
        top2 = t.topk(2, dim=1).values
        return float((top2[:, 0] - top2[:, 1]).min() / t.abs().max())
    return min(margin(x), margin(y))


def test_train_step_matches_jax(monkeypatch):
    """One f32 part-seg train step, drop paths and dropout pinned: loss,
    BatchNorm statistics, clipped gradients and AdamW's step."""
    pins = Pins(monkeypatch)
    task = "partseg"
    v = jax_variables(task)
    r = np.random.default_rng(STEP_SEED)
    pts = r.normal(size=(STEP_B, N, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[LABELS]
    seg = np.random.default_rng(6).integers(0, 50, size=(STEP_B, N))
    jm = JPartSeg(JConfigDict({**model_cfg(task), "group_size": 32}))  # the runners' groups
    args = SimpleNamespace(epoch=300, learning_rate=2e-4, weight_decay=5e-2)
    state, schedule = j_make_state(jm, v, args, 10)

    def j_step(state, pts, oh, seg):
        def loss_fn(params):
            lp, nv = jm.apply({"params": params, "batch_stats": state.batch_stats}, pts, oh,
                              train=True, rngs=dict(dropout=RNGS["dropout"],
                                                    droppath=RNGS["droppath"]),
                              mutable=["batch_stats"])
            return j_nll_seg_loss(lp, seg), nv
        (loss, nv), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return loss, nv["batch_stats"], grads, state.apply_gradients(grads)
    pins.reset()
    loss_j, stats_j, grads_j, new_j = jax.jit(j_step)(state, *map(jnp.asarray, (pts, oh, seg)))
    assert pins.calls == {"droppath": 22, "dropout": 1}  # 11 blocks at rate > 0, the head

    st = build_seg_state(task, 10, num_group=G, dtype="f32", device="cpu")
    st.model.load_state_dict(weights.seg_state_dict(v["params"], v["batch_stats"], True))
    assert group_max_margin(st.model, torch.from_numpy(pts)) > MARGIN
    before = {k: t.detach().clone() for k, t in st.model.state_dict().items()}
    pins.reset()
    loss_t = seg_step(st.model, st.optimizer, st.schedule, torch.from_numpy(pts),
                      torch.from_numpy(seg), 0, {}, torch.from_numpy(oh))
    assert pins.calls == {"droppath": 22, "dropout": 1}
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    # optax evaluates the schedule in f32, the port in f64
    assert st.schedule(0) == pytest.approx(float(schedule(0)), rel=1e-5)

    after = st.model.state_dict()
    want_stats = weights.seg_state_dict(v["params"], jax.device_get(stats_j), True)
    for k in after:
        if "running" in k:
            np.testing.assert_allclose(after[k].numpy(), want_stats[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads_j))))
    clip = min(1.0, 10.0 / norm)
    zero_stats = jax.tree_util.tree_map(np.zeros_like, jax.device_get(stats_j))
    want_g = weights.seg_state_dict(jax.device_get(grads_j), zero_stats, True)
    want_p = weights.seg_state_dict(jax.device_get(new_j.params), zero_stats, True)
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads_j)) * clip
    checked = 0
    for name, p in st.model.named_parameters():
        if not p.requires_grad:
            continue
        g, wg = p.grad.numpy(), want_g[name].numpy() * clip
        checked += 1
        if name in CANCELLED:
            assert max(np.abs(g).max(), np.abs(wg).max()) <= 1e-4 * largest, name
            continue
        scale = np.abs(wg).max()
        # the label BatchNorm normalises each channel of two clouds to about
        # +-1: what reaches label_conv is a cancellation of relative size
        # eps / var, so it holds to the largest gradient, not to its own
        ref = largest if name == "label_conv.0.weight" else scale
        assert np.abs(g - wg).max() <= 1e-4 * ref, name
        step, want_step = (p.detach() - before[name]).numpy(), (want_p[name] - before[name]).numpy()
        big = np.abs(wg) > 1e-3 * scale
        lim = 2 * np.spacing(np.abs(before[name].numpy())) + 1e-3 * np.abs(want_step)
        assert (np.abs(step - want_step) <= lim)[big].all(), name
    assert checked == len(jax.tree_util.tree_leaves(v["params"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

NPOINT = 64


@pytest.mark.parametrize("task", list(TASKS))
def test_seg_infer_fn_is_the_eval_forward(task):
    model = load_seg_model(task, num_group=G, dtype="bf16", seed=3, device="cpu")
    x = inputs(task)
    x = (x[0][:, :NPOINT].copy(),) + x[1:]
    out = build_infer_fn(model, NPOINT, with_fps=False)(*x)
    assert out.dtype == torch.float32 and out.shape == (B, NPOINT, TASKS[task][1])
    with torch.no_grad():
        assert torch.equal(out, model(*map(torch.from_numpy, x)))
    with pytest.raises(ValueError, match="points"):
        build_infer_fn(model, NPOINT, with_fps=False)(np.zeros((B, NPOINT + 1, 3), np.float32),
                                                      *x[1:])


def test_seg_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        load_seg_model("semseg")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_http.serve(task="partseg", port=0)
    with pytest.raises(ValueError, match="partseg"):
        load_seg_model("cls", device="cpu")


@pytest.fixture(scope="module")
def seg_servers():
    servers = {t: serve_http.serve(task=t, port=0, device="cpu", seed=1, npoint=NPOINT,
                                                num_group=G) for t in TASKS}
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
    for th in threads:
        th.start()
    yield servers
    for s in servers.values():
        s.shutdown()
        s.server_close()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()


def post(srv, payload):
    url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps(payload).encode()), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_seg_http_answers_labels_and_log_probs(seg_servers):
    pts = inputs("partseg")[0][:, :NPOINT]
    model = load_seg_model("partseg", num_group=G, seed=1, device="cpu")
    want = build_infer_fn(model, NPOINT, with_fps=False)(pts,
                                                         np.eye(16, dtype=np.float32)[LABELS])
    for label in (LABELS, np.eye(16)[LABELS].tolist()):  # ids, one-hot
        code, out = post(seg_servers["partseg"], {"points": pts.tolist(), "cls_label": label,
                                                  "return_log_probs": True})
        assert code == 200 and out["labels"] == want.argmax(-1).tolist()
        np.testing.assert_array_equal(np.asarray(out["log_probs"], np.float32), want.numpy())
    code, out = post(seg_servers["semseg"], {"points": pts.tolist()})
    assert code == 200 and set(out) == {"labels"} and np.asarray(out["labels"]).shape == (B, NPOINT)


@pytest.mark.parametrize("payload", [
    {"cls_label": [0, 16]}, {"cls_label": [-1, 2]}, {"cls_label": [[1, 0], [0, 1]]},
    {"cls_label": [1]}, {}, {"cls_label": [1, 2], "points": [[[0.0, 0.0, 0.0]] * 5] * 2},
    {"cls_label": [1, 2], "points": [[[float("nan")] * 3] * NPOINT] * 2},
    {"cls_label": ["a", "b"]}])
def test_seg_http_bad_requests_are_400(seg_servers, payload):
    body = {"points": inputs("partseg")[0][:, :NPOINT].tolist(), **payload}
    code, out = post(seg_servers["partseg"], body)
    assert code == 400 and "error" in out
