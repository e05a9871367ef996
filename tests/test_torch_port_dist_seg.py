"""Segmentation and ACT_PointBERT over ranks, and the fixed-order row-gather
backward, held against one process and against the JAX package on the CPU.

Two ranks run in two spawned processes joined by a gloo group, once for the
whole module (as ``tests/test_torch_port_dist.py`` does): they first run the
evaluations, while the parent builds the JAX cases, then take the steps on
their rows of the cases, and last run the segmentation CLIs under torchrun's
variables (each CLI makes and leaves a group of its own). Tolerances:

- ``evaluate_partseg`` / ``evaluate_semseg`` over 2 ranks of an unshuffled
  loader with an uneven last batch (and capped at one batch): exactly one
  process's metrics over the same clouds;
- a part-seg step (the mean NLL) and a sem-seg step with class weights, 2
  clouds of 128 points (one a rank), 16 groups of 32, a narrowed backbone
  (64 wide, 4 blocks fetched at 1, 2, 3; JAX's narrowed by subclasses of its
  modules), drop paths and dropout pinned to the same numpy masks (each rank
  its rows): against one process on the concatenated batch the mean of the
  ranks' losses within 1e-6, BatchNorm statistics within 1e-6, the clipped
  gradients within 1e-5 of each tensor's largest, the weights within 2 f32 ulp
  plus 1e-3 of the one-process step wherever its gradient exceeds 1e-3 of the
  tensor's largest; against JAX's step on that batch the rules of
  ``tests/test_torch_port_seg.py``'s step test (loss and statistics 1e-5,
  gradients 1e-4 of each tensor's largest, AdamW deltas 2 ulp + 1e-3 where
  |g| exceeds 1e-3 of the tensor's largest). Gradients that a batch-statistics
  BatchNorm cancels (``CANCELLED``, and ``label_conv``'s over two clouds, a
  cancellation of relative size eps / var) are held to the model's largest
  gradient, and their AdamW steps not at all: at rounding level, each moves
  its weight by about lr either way. The batch's group max-pools are clear by
  ``MARGIN`` (checked first) and no ReLU input of either framework crosses 0
  (seed 7 puts one across: a gradient 1e-2 off);
- an ACT_PointBERT step (the tiny config, K=8, 4 clouds, 2 a rank), the masks
  and mixup draws replayed from JAX's sown intermediates (each rank its
  rows): against one process the loss within 1e-6, q's gradients within
  1e-5 of each tensor's largest, the weights and k's EMA by the seg steps'
  rule, the running statistics within 1e-6, the queue's pointer and its
  unwritten columns exactly and the freshly written key columns within 1e-6
  (k's global BatchNorm sums over 2 ranks in another order than one
  process, so its keys differ in the last bits); against ``make_pretrain_step`` the rules of
  ``tests/test_torch_port_pointbert.py``;
- ``random_replace`` over the ranks (the permutation over the global tokens):
  exactly the one-process rows;
- ``ops.gather_rows``: its f32 backward bit-equal to ``torch.gather``'s and
  ``index_select``'s on the CPU, the 3-NN blend's too.
"""
import functools
import inspect
import os
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.engine.runner_segmentation import _make_state as j_make_state
from act_tpu.models import segmentation as jseg
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import ops, semantic_segmentation_test
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import runner_pretrain as runner
from act_tpu_torch.engine import runner_segmentation as rs
from act_tpu_torch.engine.train_state import STREAMS, pretrain_step, seg_step
from act_tpu_torch.models import MaskTransformer
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_dist import finish_ranks, free_port, start_ranks
from tests.test_torch_port_finetune import Pins
from tests.test_torch_port_model import RNGS, perturb
from tests.test_torch_port_seg import CANCELLED, MARGIN, group_max_margin
from tests import test_torch_port_pointbert as PB

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

R = 2
SEG_B, SEG_N, SEG_G = 2, 128, 16
SEG_SEED = 0  # max-pools clear by MARGIN (checked), no ReLU input across 0
WIDTHS = dict(trans_dim=64, depth=4, num_heads=4, encoder_dims=64, fetch_idx=[1, 2, 3])
SEG_WEIGHT = np.random.default_rng(3).uniform(0.5, 3.0, 13).astype(np.float32)
EVAL_N, EVAL_B = 7, 2  # clouds and batch a rank: rank 1's last batch holds a padded repeat


class JBackbone(jseg.SegBackbone):
    trans_dim: int = 64
    depth: int = 4
    num_heads: int = 4
    encoder_dims: int = 64
    fetch_idx: Tuple[int, ...] = (1, 2, 3)


class JHead(jseg._SegHead):
    trans_dim: int = 64


# the rank's code: its share of each check, results to out-<rank>.pt
WORKER = r"""
import functools, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO"])
torch.set_num_threads(1)
import torch.distributed as dist
r = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                        world_size=2, rank=r)
from act_tpu_torch import parallel
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import runner_pretrain as runner
from act_tpu_torch.engine import runner_segmentation as rs
from act_tpu_torch.engine.train_state import STREAMS, pretrain_step, seg_step
from act_tpu_torch.models import ACT_PointBERT, common
from act_tpu_torch.utils.config import ConfigDict
# EVAL_HELPERS

out = {}
rows = lambda a, b: a[r * b:(r + 1) * b]

# the evaluations, each rank its share of an unshuffled loader
for task in ("partseg", "semseg"):
    loader = DataLoader(EvalClouds(task), EVAL_B, prefetch=0, num_replicas=2, rank=r)
    fn = rs.evaluate_partseg if task == "partseg" else rs.evaluate_semseg
    out["eval " + task] = [fn(eval_infer(task), loader, logger="silent", max_batches=n)
                           for n in (None, 1)]

# the cases, written meanwhile by the parent
while not os.path.exists(os.environ["INPUTS"]):
    time.sleep(0.05)
inp = torch.load(os.environ["INPUTS"], weights_only=False)

# drop paths and dropouts pinned to the global masks' rows
calls = {"droppath": 0, "dropout": 0}

def mask(kind, shape, keep):
    i = calls[kind]
    calls[kind] += 1
    gshape = (shape[0] * 2,) + tuple(shape[1:])
    m = np.random.default_rng([11, 0 if kind == "droppath" else 1, i]).random(gshape) < keep
    return torch.from_numpy(m[r * shape[0]:(r + 1) * shape[0]])

def droppath(self, x, rngs=None):
    if not self.training or self.rate == 0.0:
        return x
    keep = 1.0 - self.rate
    m = mask("droppath", (x.shape[0],) + (1,) * (x.dim() - 1), keep)
    return torch.where(m, x / common.scalar(keep, x), common.scalar(0.0, x))

def dropout(self, x, rngs=None):
    if not self.training or self.rate == 0.0:
        return x
    m = mask("dropout", tuple(x.shape), 1.0 - self.rate)
    return torch.where(m, x / common.scalar(1.0 - self.rate, x), common.scalar(0.0, x))

common.DropPath.forward, common.Dropout.forward = droppath, dropout

# the part-seg and the weighted sem-seg step, one cloud a rank
for task in ("partseg", "semseg"):
    c = inp[task]
    st = rs.build_seg_state(task, 10, num_group=c["G"], dtype="f32", device="cpu",
                            widths=c["widths"])
    st.model.load_state_dict(c["sd"])
    calls.update(droppath=0, dropout=0)
    loss = seg_step(st.model, st.optimizer, st.schedule, rows(c["pts"], 1), rows(c["seg"], 1),
                    0, {}, None if c["oh"] is None else rows(c["oh"], 1), c["weight"])
    out[task] = dict(loss=float(loss), sd=st.model.state_dict(), calls=dict(calls),
                     grads={n: p.grad for n, p in st.model.named_parameters() if p.requires_grad})

# one ACT_PointBERT step, 2 clouds a rank, the sown draws' rows
c = inp["pb"]
model = ACT_PointBERT(ConfigDict(c["cfg"]))
model.load_state_dict(c["sd"])
runner.freeze_tokenizer(model, ConfigDict(dict(model=dict(c["cfg"], frozen_bf16=False))))
opt, schedule = builder.build_optimizer(ConfigDict(c["train_cfg"]), model, 4)
model.forward = functools.partial(model.forward, masks=tuple(rows(m, 2) for m in c["masks"]),
                                  mixup=tuple(rows(m, 2) for m in c["mixup"]))
gens = {name: torch.Generator() for name in STREAMS}
loss = pretrain_step(model, opt, schedule, rows(c["pts"], 2), 0, gens, transform=None,
                     ema_momentum=c["m"])
out["pb"] = dict(loss=float(loss), sd=model.state_dict(),
                 grads={n: p.grad for n, p in model.named_parameters() if p.requires_grad})
# the token replacement: the permutation over the global batch's tokens
q = model.transformer_q
q.replace_pob = 0.5
out["replace"] = q.random_replace(rows(c["tokens"], 2), rows(c["tmask"], 2), False,
                                  {"mask": torch.Generator().manual_seed(3)})
dist.destroy_process_group()

# the CLIs under torchrun's variables: each makes its group and leaves it
os.environ.update(MASTER_ADDR="127.0.0.1", WORLD_SIZE="2", LOCAL_RANK="0")
os.chdir(os.environ["CLI_DIR"])
from act_tpu_torch import part_segmentation, semantic_segmentation, semantic_segmentation_test
seen = {}

def spy(fn, key):
    def wrapped(**kw):
        seen[key] = (parallel.process_count(), parallel.process_index(), str(kw["device"]))
        return fn(**kw)
    return wrapped

rs.run_partseg, rs.run_semseg = spy(rs.run_partseg, "partseg"), spy(rs.run_semseg, "semseg")
common_args = ["--device", "cpu", "--steps", "1", "--epoch", "1", "--npoint", "64",
               "--num_group", "16", "--batch_size", "4", "--root", "none", "--num_workers", "0"]
os.environ["MASTER_PORT"] = os.environ["PORT2"]
part_segmentation.main(common_args + ["--log_dir", "p"])
os.environ["MASTER_PORT"] = os.environ["PORT3"]
semantic_segmentation.main(common_args + ["--log_dir", "s"])
out["cli"] = dict(seen, after=parallel.is_distributed())
try:
    semantic_segmentation_test.main(["--device", "cpu", "--root", "none"])
    out["whole_scene"] = None
except RuntimeError as e:
    out["whole_scene"] = str(e)
torch.save(out, os.path.join(os.environ["OUT"], "out-%d.pt" % r))
"""


# ---------------------------------------------------------------------------
# the evaluation's clouds: each carries its own index, and the log-probs of
# ``eval_infer`` are a fixed function of it
# ---------------------------------------------------------------------------

def eval_logits(task):
    n_cls = 50 if task == "partseg" else 13
    return np.log(np.random.default_rng(9).dirichlet(np.ones(n_cls), size=(EVAL_N, 30))
                  ).astype(np.float32)


class EvalClouds:
    """``EVAL_N`` clouds of 30 points whose first coordinate is the cloud's
    index, each with a category and labels drawn from its parts (the sixth's
    labels its own argmax, so an IoU is high)."""

    def __init__(self, task):
        self.task = task
        rng = np.random.default_rng(4)
        self.cats = rng.integers(0, 16, EVAL_N)
        if task == "partseg":
            self.labels = np.stack([rng.choice(rs.SEG_CLASSES[rs.CATEGORIES[c]], 30)
                                    for c in self.cats])
        else:
            self.labels = rng.integers(0, 13, (EVAL_N, 30))
            self.labels[5] = eval_logits(task)[5].argmax(-1)

    def __len__(self):
        return EVAL_N

    def __getitem__(self, i):
        pts = np.zeros((30, 3), np.float32)
        pts[:, 0] = i
        if self.task == "partseg":
            return pts, int(self.cats[i]), self.labels[i]
        return pts, self.labels[i]


def eval_infer(task):
    table = torch.from_numpy(eval_logits(task))

    def infer(pts, *one_hot):
        return table[torch.as_tensor(np.asarray(pts)[:, 0, 0]).long()]
    return infer


# ---------------------------------------------------------------------------
# the cases: JAX variables and steps, built while the ranks evaluate
# ---------------------------------------------------------------------------

def t(a):
    return torch.from_numpy(np.array(a))


def seg_batch(task):
    rng = np.random.default_rng(SEG_SEED)
    pts = rng.normal(size=(SEG_B, SEG_N, 3)).astype(np.float32)
    seg = np.random.default_rng(6).integers(0, 50 if task == "partseg" else 13,
                                            size=(SEG_B, SEG_N))
    oh = np.eye(16, dtype=np.float32)[[2, 9]] if task == "partseg" else None
    return pts, oh, seg


def jax_seg_model(task, mp):
    """The narrowed JAX model of ``task``, ``JBackbone`` and ``JHead`` patched
    into ``act_tpu.models.segmentation`` through ``mp``."""
    mp.setattr(jseg, "SegBackbone", JBackbone)
    mp.setattr(jseg, "_SegHead", JHead)
    cls = jseg.PartSegTransformer if task == "partseg" else jseg.SemSegTransformer
    return cls(JConfigDict(dict(NAME=cls.__name__, cls_dim=50 if task == "partseg" else 13,
                                num_group=SEG_G, group_size=32)))


def jax_seg_vars(task):
    """The narrowed JAX model's perturbed variables (``init`` jitted)."""
    pts, oh, _ = seg_batch(task)
    with pytest.MonkeyPatch.context() as mp:
        jm = jax_seg_model(task, mp)
        v = jax.device_get(jax.jit(lambda *x: jm.init(RNGS, *x))(
            *(jnp.asarray(x) for x in (pts, oh) if x is not None)))
    return {k: perturb(x, np.random.default_rng(7)) for k, x in v.items()}


def jax_seg_step(task, v):
    """JAX's train step of the narrowed model from ``v`` on the batch, drop
    paths and dropout pinned: (loss, new batch statistics, gradients, new
    params)."""
    pts, oh, seg = seg_batch(task)
    weight = None if task == "partseg" else jnp.asarray(SEG_WEIGHT)
    inputs = tuple(jnp.asarray(x) for x in (pts, oh) if x is not None)
    with pytest.MonkeyPatch.context() as mp:
        jm = jax_seg_model(task, mp)
        pins = Pins(mp)
        args = SimpleNamespace(epoch=300, learning_rate=2e-4, weight_decay=5e-2)
        state, _ = j_make_state(jm, v, args, 10)

        def j_step(state, seg, *inputs):
            def loss_fn(params):
                lp, nv = jm.apply({"params": params, "batch_stats": state.batch_stats}, *inputs,
                                  train=True, rngs=dict(dropout=RNGS["dropout"],
                                                        droppath=RNGS["droppath"]),
                                  mutable=["batch_stats"])
                return jseg.nll_seg_loss(lp, seg, weight), nv
            (loss, nv), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            return loss, nv["batch_stats"], grads, state.apply_gradients(grads).params
        pins.reset()
        return jax.device_get(jax.jit(j_step)(state, jnp.asarray(seg), *inputs))


def port_seg_state(task, v):
    st = rs.build_seg_state(task, 10, num_group=SEG_G, dtype="f32", device="cpu",
                            widths=WIDTHS)
    st.model.load_state_dict(weights.seg_state_dict(v["params"], v["batch_stats"],
                                                    task == "partseg"), strict=True)
    return st


def hand_inputs(inputs, out_dir) -> None:
    """Write the ranks' cases whole, then rename them into place."""
    path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, path + ".part")
    os.replace(path + ".part", path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, with the cases they were computed on. The ranks
    evaluate while the JAX variables are drawn, and step while JAX's steps
    compile."""
    out_dir, cli_dir = tmp_path_factory.mktemp("ranks"), tmp_path_factory.mktemp("cli")
    helpers = f"EVAL_N, EVAL_B = {EVAL_N}, {EVAL_B}\n" + "".join(
        inspect.getsource(f) for f in (eval_logits, EvalClouds, eval_infer))
    procs = start_ranks(WORKER.replace("# EVAL_HELPERS\n", helpers), out_dir,
                        CLI_DIR=str(cli_dir), PORT2=str(free_port()), PORT3=str(free_port()))
    try:
        seg = {task: dict(v=jax_seg_vars(task)) for task in ("partseg", "semseg")}
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(PB.BS, PB.NPTS, 3)).astype(np.float32)
        cfg = PB.bert_model_cfg(moco=True)
        v = PB.jax_vars(PB.JBERT(cfg), rng, pts)
        j_loss, (masks, mixup), j_grads = PB.jax_bert_grads(pts, cfg, v)
        pb = dict(pts=pts, cfg=cfg, v=v, j_loss=j_loss, masks=masks, mixup=mixup,
                  j_grads=j_grads)
        tok = np.random.default_rng(5)
        inputs = {}
        for task, c in seg.items():
            p, oh, y = seg_batch(task)
            inputs[task] = dict(sd=port_seg_state(task, c["v"]).model.state_dict(), G=SEG_G,
                                widths=WIDTHS, pts=t(p), seg=t(y),
                                oh=None if oh is None else t(oh),
                                weight=None if task == "partseg" else t(SEG_WEIGHT))
        inputs["pb"] = dict(sd=PB.port_bert(cfg, v).state_dict(), cfg=dict(cfg),
                            train_cfg=dict(PB.train_cfg(cfg)), m=float(cfg.m), pts=t(pts),
                            masks=masks, mixup=mixup,
                            tokens=t(tok.normal(size=(4, 16, 8)).astype(np.float32)),
                            tmask=t(tok.random((4, 16)) < 0.3))
        hand_inputs(inputs, out_dir)
        for task, c in seg.items():
            c["step"] = jax_seg_step(task, c["v"])
        pb["j_state"], step_loss = PB.jax_bert_state(pts, cfg, v)
        assert step_loss == float(j_loss)
        outs = finish_ranks(procs, inputs, out_dir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(seg=seg, pb=pb, inputs=inputs, outs=outs, cli_dir=cli_dir)


# ---------------------------------------------------------------------------
# the evaluations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["partseg", "semseg"])
def test_evaluation_over_ranks_equals_one_process(ranks, task):
    """Every rank's metrics over its share of 7 clouds (the last batch with a
    padded repeat), and over its first batch, equal one process's over the
    same clouds exactly."""
    fn = rs.evaluate_partseg if task == "partseg" else rs.evaluate_semseg
    for cap, n_clouds in ((None, EVAL_N), (1, R * EVAL_B)):
        want = fn(eval_infer(task), DataLoader(EvalClouds(task), n_clouds, prefetch=0),
                  logger="silent", max_batches=1)
        for out in ranks["outs"]:
            got = out[f"eval {task}"][0 if cap is None else 1]
            assert got == want, (cap, got, want)
    assert 0.0 < want[next(iter(want))] < 1.0


# ---------------------------------------------------------------------------
# the segmentation steps
# ---------------------------------------------------------------------------

def assert_grads_close(got, want, cancelled):
    """Gradients within 1e-5 of each tensor's largest; those that a
    batch-statistics BatchNorm cancels (``cancelled``: zero, or a small
    difference, up to rounding) within 1e-5 of the model's largest gradient."""
    largest = max(float(g.abs().max()) for g in want.values())
    for n, g in got.items():
        scale = largest if n in cancelled else float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= 1e-5 * scale, n


def assert_steps_close(got, want, before, grads, cancelled):
    """The weights after AdamW within 2 f32 ulp plus 1e-3 of the one-process
    step wherever the one-process gradient exceeds 1e-3 of its tensor's
    largest (a gradient at rounding level, as ``cancelled``'s are, moves its
    weight by about lr either way)."""
    for n, g in grads.items():
        if n in cancelled:
            continue
        big = g.abs() > 1e-3 * g.abs().max()
        lim = (2 * torch.finfo(torch.float32).eps * before[n].abs()
               + 1e-3 * (want[n] - before[n]).abs())
        assert ((got[n] - want[n]).abs() <= lim)[big].all(), n


def one_process_seg_step(task, c, monkeypatch):
    st = port_seg_state(task, c["v"])
    pts, oh, seg = seg_batch(task)
    assert group_max_margin(st.model, t(pts)) > MARGIN
    before = {k: x.clone() for k, x in st.model.state_dict().items()}
    Pins(monkeypatch)
    loss = seg_step(st.model, st.optimizer, st.schedule, t(pts), t(seg), 0, {},
                    None if oh is None else t(oh), None if task == "partseg" else t(SEG_WEIGHT))
    grads = {n: p.grad.clone() for n, p in st.model.named_parameters() if p.requires_grad}
    return float(loss), grads, before, st.model.state_dict()


@pytest.mark.parametrize("task", ["partseg", "semseg"])
def test_seg_step_over_ranks_matches_one_process_and_jax(ranks, task, monkeypatch):
    """One f32 step over 2 ranks (one cloud each; sem seg with class weights)
    against one process on both clouds and against JAX's step (the tolerances
    of the module docstring)."""
    c = ranks["seg"][task]
    loss1, grads1, before, after1 = one_process_seg_step(task, c, monkeypatch)
    outs = [o[task] for o in ranks["outs"]]
    assert outs[0]["calls"] == outs[1]["calls"] and outs[0]["calls"]["droppath"] > 0
    # the ranks agree bit for bit on what they hold in common
    assert all(torch.equal(x, outs[1]["sd"][k]) for k, x in outs[0]["sd"].items())
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), loss1, rtol=1e-6)
    sd, grads = outs[0]["sd"], outs[0]["grads"]
    for k, x in sd.items():
        if "running" in k:
            np.testing.assert_allclose(x.numpy(), after1[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    # label_conv's gradient is a cancellation of relative size eps / var (the
    # label BatchNorm over two clouds): held to the model's largest gradient
    cancelled = CANCELLED | {"label_conv.0.weight"}
    assert_grads_close(grads, grads1, cancelled)
    assert_steps_close(sd, after1, before, grads1, cancelled)

    # against JAX's step on the concatenated batch
    loss_j, stats_j, grads_j, params_j = c["step"]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), float(loss_j), rtol=1e-5)
    with_label = task == "partseg"
    want_stats = weights.seg_state_dict(c["v"]["params"], stats_j, with_label)
    for k, x in sd.items():
        if "running" in k:
            np.testing.assert_allclose(x.numpy(), want_stats[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in jax.tree_util.tree_leaves(grads_j))))
    clip = min(1.0, 10.0 / norm)
    zero = jax.tree_util.tree_map(np.zeros_like, stats_j)
    want_g = weights.seg_state_dict(grads_j, zero, with_label)
    want_p = weights.seg_state_dict(params_j, zero, with_label)
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads_j)) * clip
    for name, g in grads.items():
        wg = want_g[name].numpy() * clip
        if name in CANCELLED:
            assert max(np.abs(g.numpy()).max(), np.abs(wg).max()) <= 1e-4 * largest, name
            continue
        scale = np.abs(wg).max()
        ref = largest if name == "label_conv.0.weight" else scale
        assert np.abs(g.numpy() - wg).max() <= 1e-4 * ref, name
        d, want_d = (sd[name] - before[name]).numpy(), (want_p[name] - before[name]).numpy()
        big = np.abs(wg) > 1e-3 * scale
        lim = 2 * np.spacing(np.abs(before[name].numpy())) + 1e-3 * np.abs(want_d)
        assert (np.abs(d - want_d) <= lim)[big].all(), name


def test_weighted_seg_loss_divides_by_the_global_weight_sum(ranks):
    """The sem-seg step's per-rank losses are R x their numerator over the
    global weight sum: each differs from the one-cloud loss of its own
    rows, and their mean is JAX's loss on both clouds."""
    c = ranks["seg"]["semseg"]
    got = [o["semseg"]["loss"] for o in ranks["outs"]]
    assert abs(got[0] - got[1]) > 1e-3
    np.testing.assert_allclose(np.mean(got), float(c["step"][0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# ACT_PointBERT
# ---------------------------------------------------------------------------

def test_pointbert_step_over_ranks_matches_one_process_and_jax(ranks):
    """One f32 ACT_PointBERT step over 2 ranks (2 clouds each: the mixup's
    partners, the cutmix keys and the enqueued keys come from the other
    rank) against one process on the 4 clouds and against
    ``make_pretrain_step`` (the tolerances of the module docstring)."""
    c, inp = ranks["pb"], ranks["inputs"]["pb"]
    model = PB.port_bert(c["cfg"], c["v"])
    runner.freeze_tokenizer(model, ConfigDict(dict(model=dict(c["cfg"], frozen_bf16=False))))
    opt, schedule = builder.build_optimizer(PB.train_cfg(c["cfg"]), model, 4)
    model.forward = functools.partial(model.forward, masks=c["masks"], mixup=c["mixup"])
    before = {k: x.clone() for k, x in model.state_dict().items()}
    loss1 = pretrain_step(model, opt, schedule, t(c["pts"]), 0,
                          {name: torch.Generator() for name in STREAMS}, transform=None,
                          ema_momentum=inp["m"])
    after1 = model.state_dict()
    grads1 = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    outs = [o["pb"] for o in ranks["outs"]]
    assert all(torch.equal(x, outs[1]["sd"][k]) for k, x in outs[0]["sd"].items())
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), float(loss1), rtol=1e-6)
    sd, grads = outs[0]["sd"], outs[0]["grads"]
    noise = {"transformer_q.encoder.first_conv.3.bias"}  # cancelled by its BatchNorm
    assert_grads_close(grads, grads1, noise)
    assert_steps_close(sd, after1, before, grads1, noise)
    # k's EMA of those steps, the running statistics, the queue and its pointer
    for k, x in sd.items():
        if k.startswith("transformer_k.") and "running" not in k and "num_batches" not in k:
            q = "transformer_q." + k[len("transformer_k."):]
            if q in grads1 and q not in noise:
                big = grads1[q].abs() > 1e-3 * grads1[q].abs().max()
                lim = (2 * torch.finfo(torch.float32).eps * before[k].abs()
                       + 1e-3 * (after1[k] - before[k]).abs())
                assert ((x - after1[k]).abs() <= lim)[big].all(), k
        elif "running" in k:
            np.testing.assert_allclose(x.numpy(), after1[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert int(sd["queue_ptr"]) == int(after1["queue_ptr"]) == PB.BS
    assert torch.equal(sd["queue"][:, PB.BS:], after1["queue"][:, PB.BS:])  # unwritten
    np.testing.assert_allclose(sd["queue"][:, :PB.BS].numpy(), after1["queue"][:, :PB.BS].numpy(),
                               rtol=0, atol=1e-6)
    PB.check_bert_step(grads, before, sd, schedule(0), c["v"], c["j_grads"], c["j_state"],
                       inp["m"])


def test_token_replacement_permutes_the_global_batch(ranks):
    """``random_replace`` on each rank's rows equals the one-process
    replacement of the 4 clouds' tokens, rows for rows."""
    inp = ranks["inputs"]["pb"]
    q = MaskTransformer(ConfigDict(inp["cfg"]))
    q.replace_pob = 0.5
    want = q.random_replace(inp["tokens"], inp["tmask"], False,
                            {"mask": torch.Generator().manual_seed(3)})
    for r, out in enumerate(ranks["outs"]):
        for got, w in zip(out["replace"], want):
            assert torch.equal(got, w[2 * r:2 * r + 2])
    assert not torch.equal(want[0], inp["tokens"])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_seg_clis_join_the_group_and_the_whole_scene_cli_refuses(ranks):
    """Under torchrun's variables both training CLIs run over the 2 ranks
    (the runner sees 2 processes) and leave their group; rank 0 alone writes
    each run's ckpt-best and log; the whole-scene CLI raises."""
    for r, out in enumerate(ranks["outs"]):
        cli = out["cli"]
        assert cli["partseg"] == cli["semseg"] == (R, r, "cpu") and not cli["after"]
        assert out["whole_scene"] == semantic_segmentation_test.WHOLE_SCENE_RANKS
    for sub in ("work_dirs/part_seg/p", "work_dirs/sem_seg/s"):
        path = ranks["cli_dir"] / sub
        assert sorted(os.listdir(path)) == ["ckpt-best.pth", "train.log"], sub
        assert (path / "train.log").stat().st_size > 0


def test_batch_size_must_divide_over_the_ranks(monkeypatch):
    monkeypatch.setattr(rs, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="divide over 3 ranks"):
        rs._loader(EvalClouds("semseg"), 4, True, 0, 0)


# ---------------------------------------------------------------------------
# the row gather's fixed-order backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,M,C", [(2, 7, 50, 33), (4, 16, 64, 8), (1, 5, 3000, 3)])
def test_gather_rows_backward_equals_torch_gather_and_index_select(B, S, M, C):
    """f32 on the CPU: ``ops.gather_rows``'s backward (the plain version of
    the kernel) equals ``torch.gather``'s and ``index_select``'s own bit for
    bit, magnitudes 1e-6 to 1e6 and many sources a row included."""
    g = torch.Generator().manual_seed(B * S)
    table = torch.randn(B, S, C, generator=g)
    idx = torch.randint(0, S, (B, M), generator=g, dtype=torch.int32)
    grad = torch.randn(B, M, C, generator=g) * 10.0 ** torch.randint(-6, 7, (B, M, 1),
                                                                    generator=g).float()
    a, b, c = (table.clone().requires_grad_() for _ in range(3))
    ops.gather_rows(a, idx).backward(grad)
    torch.gather(b, 1, idx.long()[..., None].expand(-1, -1, C)).backward(grad)
    rows = (idx.long() + S * torch.arange(B)[:, None]).reshape(-1)
    c.reshape(B * S, C).index_select(0, rows).backward(grad.reshape(-1, C))
    assert torch.equal(a.grad, b.grad) and torch.equal(a.grad, c.grad)
    assert torch.equal(ops.gather_rows(table, idx), torch.gather(
        table, 1, idx.long()[..., None].expand(-1, -1, C)))


def test_three_nn_blend_gradients_equal_the_index_select_form():
    """The 3-NN blend through ``gather_rows`` gives the values and f32
    gradients (to the features and both coordinate arguments) of its
    ``index_select`` form bit for bit."""
    g = torch.Generator().manual_seed(1)
    unknown, known = torch.randn(2, 60, 3, generator=g), torch.randn(2, 9, 3, generator=g)
    feats = torch.randn(2, 9, 17, generator=g)
    _, idx = ops.knn_ref(known, unknown, 3)
    grad = torch.randn(2, 60, 17, generator=g)

    def index_select_form(u, k, f):
        d = ((u[:, :, None, :] - ops.gather_points(k, idx)) ** 2).sum(-1)
        w = 1.0 / (d + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        rows = (idx.long() + 9 * torch.arange(2)[:, None, None]).reshape(120, 3)
        out = None
        for j in range(3):
            term = f.reshape(18, 17).index_select(0, rows[:, j]) * w.reshape(120, 3)[:, j, None]
            out = term if out is None else out + term
        return out.reshape(2, 60, 17)
    runs = []
    for fn in (lambda u, k, f: ops.three_nn_interpolate(u, k, f), index_select_form):
        u, k, f = (x.clone().requires_grad_() for x in (unknown, known, feats))
        out = fn(u, k, f)
        out.backward(grad)
        runs.append([out.detach(), u.grad, k.grad, f.grad])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
