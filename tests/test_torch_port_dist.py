"""The port's data parallelism held against one process and against the JAX package.

Two ranks run in two spawned processes joined by a gloo group on the CPU,
once for the whole module (as ``tests/test_multiprocess.py`` batches its
checks in one ``WORKER``): each rank writes what it computed to a file, and
the tests below hold it against one process on the concatenated batch and,
for the steps, against JAX's step on a batch-sharded mesh of the CPU devices
(``tests/conftest.py``). Tolerances:

- collectives, the loader's shards, the draws, the Gumbel ids and the Stage-I
  table: exact (integer or copied values; the table's rows back in the
  index order, so the same sums);
- global BatchNorm (inputs of mean 3 and spread 1): outputs, input
  gradients, running statistics and the weight and bias gradients (summed
  over the ranks) within 1e-5 of each tensor's largest magnitude (f32 sums
  of another order, through flax's E[x^2] - E[x]^2);
- one finetune step (B = 8: 4 a rank; the mlp-3 head, drop path 0.3 and the
  head's dropouts pinned to the same numpy masks, each rank its rows) and one
  Stage-I step (B = 4: 2 a rank; the Gumbel uniforms pinned to JAX's, prompt
  dropout off) under ``tests/test_torch_port_train.py``'s rules: loss and
  statistics within 1e-5, gradients within 1e-4 of each tensor's largest
  gradient (except where the reference's is zero up to rounding: below 1e-6
  of the largest), the AdamW deltas within 2 f32 ulp + 1e-3 of the reference
  delta wherever the reference gradient is at least 1e-6. Both steps run the
  clip (it engages). The finetune step's seed has every max-pool choice
  clear by 5e-7 at B = 8 on the 8-device mesh (checked first: a closer call
  lets 1-ulp differences route a gradient to the other candidate); no
  Stage-I seed of 8 clouds among the first 20 had all its max-pool and
  Chamfer choices that clear, so its JAX step runs at 4 clouds on a
  4-device mesh, a cloud a device.
"""
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from act_tpu.datasets.loader import DataLoader as JDataLoader
from act_tpu.engine import builder as jbuilder
from act_tpu.engine.train_state import TrainState, make_autoencoder_step, make_finetune_step
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.ops.sampling import _gumbel_argmax as j_gumbel_argmax
from act_tpu.parallel import make_mesh

from act_tpu_torch import ops
from act_tpu_torch.datasets import scale_and_translate
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.datasets.transforms import rotate_y
from act_tpu_torch.engine import builder
from act_tpu_torch.engine.runner_autoencoder import build_autoencoder_model, validate
from act_tpu_torch.engine.train_state import STREAMS, autoencoder_step, finetune_step
from act_tpu_torch.models import common
from act_tpu_torch.models.act import block_mask, random_mask
from act_tpu_torch.ops.group import subset_draw
from act_tpu_torch.parallel import rand_local, randint_local

from tests import test_torch_port_finetune as F
from tests.test_torch_port_finetune_data import small_run_cfg
from tests.test_torch_port_model import perturb
from tests.test_torch_port_stage2 import RNGS
from tests import test_torch_port_stage1 as S1
from tests.test_torch_port_gumbel import SEED_WORDS, near_tie_rows, seed_tensor
from tests.test_torch_port_ops import interpret  # noqa: F401 (a fixture)

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, FT_B, S1_B = 2, 8, 4
FT_SEED = 2  # every max-pool choice of the B = 8 step clear by F.MARGIN (checked)
S1_SEED = 17  # every max-pool and Chamfer choice of the B = 4 step clear by 5e-7 (checked)
TEMP, KLDW = 0.5, 0.05
GUMBEL_SHAPE = (2 * 24, 300)  # 24 rows a rank, V not a multiple of a tile
TABLE_TAX = ["02691156", "03001627", "02691156", "04379243", "03001627"]  # 5 clouds, odd

# the rank's code: its share of each check, results to out-<rank>.pt
WORKER = r"""
import os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO"])
torch.set_num_threads(1)
import torch.distributed as dist
r = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                        world_size=2, rank=r)
from act_tpu_torch import ops, parallel
from act_tpu_torch.datasets import scale_and_translate
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.datasets.transforms import rotate_y
from act_tpu_torch.engine import builder
from act_tpu_torch.engine.runner_autoencoder import validate
from act_tpu_torch.engine.train_state import STREAMS, autoencoder_step, finetune_step
from act_tpu_torch.models import MODELS, common
from act_tpu_torch.models.act import block_mask, random_mask
from act_tpu_torch.ops.group import subset_draw
from act_tpu_torch.utils.config import ConfigDict

out = {}
rows = lambda a, b: a[r * b:(r + 1) * b]

# collectives: first dims of 1 and 2 rows; strings
out["gather"] = parallel.gather_concat(np.full((r + 1, 2), r, np.int32))
out["gather_str"] = parallel.gather_concat(np.asarray(["t%d" % r] * (r + 1), dtype=object))
out["mean"] = parallel.reduce_mean_scalar(float(r + 1))

# the preemption flag agreed over the ranks: only rank 1 is asked to stop, in a
# bare loop after its 2nd step, then in a small finetune run_net after its 1st
# (first, while the parent builds the inputs of the rest)
from act_tpu_torch.engine import runner_finetune
from act_tpu_torch.engine.preemption import GUARD, PreemptionGuard
g = PreemptionGuard(at_step=2 if r == 1 else None)
stops = [n for n in range(1, 5) if g.check(n)]
cfg, exp = ConfigDict(eval(os.environ["PREEMPT_CFG"])), os.environ["PREEMPT_EXP"]
whole = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=3,
                                experiment_path=exp + "/whole")
GUARD.at_step = 1 if r == 1 else None
cut = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=3,
                              experiment_path=exp + "/cut")
GUARD.reset()
GUARD.at_step = None
saved = torch.load(exp + "/cut/ckpt-last.pth", weights_only=True)
rest = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=2, resume=True,
                               experiment_path=exp + "/cut")
out["preempt"] = dict(
    stop=stops[0] if stops else None, cursor=saved["data_iter"],
    draw_states=len(saved["dataset_rng"]), cut=(cut.preempted, cut.steps),
    steps=(rest.steps, whole.steps),
    same=all(torch.equal(x, rest.state.model.state_dict()[k])
             for k, x in whole.state.model.state_dict().items()))

# the other checks' inputs, written meanwhile by the parent
while not os.path.exists(os.environ["INPUTS"]):
    time.sleep(0.05)
inp = torch.load(os.environ["INPUTS"], weights_only=False)

# the draws of a step, each rank its rows of the global draw
g = torch.Generator().manual_seed(5)
pts = rows(inp["draw_pts"], 4)
out["draws"] = [parallel.rand_local((4, 3), g), scale_and_translate(pts, g),
                rotate_y(pts, g), subset_draw(4, 10, 6, g, "cpu"),
                random_mask(g, 4, 8, 3), block_mask(g, rows(inp["draw_centers"], 4), 3),
                parallel.randint_local(7, (4, 2), g), torch.rand(3, generator=g)]

# global BatchNorm and its gradients
bn = common.BatchNorm(6)
bn.load_state_dict(inp["bn_sd"])
x = rows(inp["bn_x"], 4).clone().requires_grad_()
y = bn.train()(x)
(y * rows(inp["bn_w"], 4)).sum().backward()
out["bn"] = dict(y=y.detach(), xg=x.grad, wg=bn.weight.grad, bg=bn.bias.grad,
                 rm=bn.running_mean, rv=bn.running_var)

# the Gumbel ids of this rank's rows (seed folded with the rank)
out["gumbel"] = ops.gumbel_argmax(rows(inp["gumbel_x"], inp["gumbel_x"].shape[0] // 2),
                                  inp["gumbel_seed"])

# one finetune step, drop path and dropout pinned to the global masks' rows
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
ft = inp["ft"]
model = MODELS.build(ConfigDict(ft["model_cfg"]))
model.load_state_dict(ft["sd"], strict=True)
opt, schedule = builder.build_optimizer(ConfigDict(ft["cfg"]), model, 4)
gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}
loss, acc = finetune_step(model, opt, schedule, rows(ft["pts"], 4), rows(ft["labels"], 4),
                          0, gens, grad_norm_clip=ft["cfg"]["grad_norm_clip"])
out["ft"] = dict(loss=float(loss), acc=float(acc), sd=model.state_dict(),
                 grads={n: p.grad for n, p in model.named_parameters() if p.requires_grad})

# one Stage-I step, the Gumbel uniforms pinned, prompt dropout off
common.Dropout.forward = lambda self, x, rngs=None: x
s1 = inp["s1"]
cfg = ConfigDict(s1["cfg"])
model = MODELS.build(cfg.model)
model.load_state_dict(s1["sd"], strict=True)
builder.freeze_teacher_backbone(model, cast_bf16=False)
opt, schedule = builder.build_optimizer(cfg, model, 4)
fwd = model.forward
model.forward = lambda *a, **k: fwd(*a, gumbel_u=rows(s1["u"], s1["b"]), **k)
out_s1 = autoencoder_step(model, opt, schedule, rows(s1["pts"], s1["b"]), 0, gens, s1["temp"],
                          s1["kldw"], grad_norm_clip=cfg.grad_norm_clip)
out["s1"] = dict(loss=[float(v) for v in out_s1], sd=model.state_dict(),
                 grads={n: p.grad for n, p in model.named_parameters() if p.requires_grad})

# the Stage-I table over 5 clouds, 3 on rank 0 and 2 + a padded repeat on rank 1
class Clouds:
    def __init__(self, tax, clouds):
        self.tax, self.clouds = tax, clouds
    def __len__(self):
        return len(self.tax)
    def __getitem__(self, i):
        return self.tax[i], str(i), self.clouds[i]

tb = inp["table"]
model = MODELS.build(ConfigDict(tb["model_cfg"]))
model.load_state_dict(tb["sd"], strict=True)
loader = DataLoader(Clouds(tb["tax"], tb["clouds"]), 1, prefetch=0, num_replicas=2, rank=r)
metrics, per_cloud = validate(model, loader, logger="silent")
out["table"] = dict(table=metrics.table, rows=per_cloud)

torch.save(out, os.path.join(os.environ["OUT"], "out-%d.pt" % r))
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(script: str, out_dir, **env) -> list:
    """Start ``script`` as ranks 0 and 1 of a gloo group, with ``env`` added
    to their environment; they read ``finish_ranks``'s inputs when it writes
    them."""
    env = {**os.environ, **env, "REPO": REPO, "INPUTS": os.path.join(out_dir, "inputs.pt"),
           "OUT": str(out_dir), "PORT": str(free_port()), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", script], env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(R)]


def finish_ranks(procs: list, inputs: dict, out_dir, timeout: int = 240) -> list:
    """Hand the ranks ``inputs`` (written whole, then renamed), wait for
    them, and return each rank's ``out-<rank>.pt``."""
    path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, path + ".part")
    os.replace(path + ".part", path)
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(os.path.join(out_dir, f"out-{r}.pt"), weights_only=False)
            for r in range(R)]


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the inputs, and one run of both ranks
# ---------------------------------------------------------------------------

def finetune_case():
    """The finetune step's config, JAX variables (perturbed, the head's
    BatchNorm inputs centred), clouds and labels."""
    rng = np.random.default_rng(FT_SEED)
    model_cfg = F.tiny_cfg("full", 0.3)
    cfg = F.train_cfg(model_cfg)
    cfg.grad_norm_clip, cfg.total_bs = 1.0, FT_B
    jm, v = F.jax_model(model_cfg, rng)
    pts = F.clouds(rng, n=FT_B)
    labels = rng.integers(0, F.CLS, FT_B).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        v = F.centre_head(model_cfg, v, pts, F.Pins(mp))
    return dict(model_cfg=model_cfg, cfg=cfg, jm=jm, v=v, pts=pts, labels=labels)


def stage1_case():
    """The Stage-I step of ``tests/test_torch_port_stage1.py`` at 4 clouds
    of 8 groups: config, JAX variables, clouds, and JAX's Gumbel uniforms of
    the step."""
    rng = np.random.default_rng(S1_SEED)
    cfg = S1.smoke_cfg(clip=0.5)
    cfg.model.num_group = 8
    pts = rng.normal(size=(S1_B, 128, 3)).astype(np.float32)
    # S1.jax_model's module and variables, its init jitted (the same values, sooner)
    jm = (S1.JViT if cfg.model.NAME.startswith("ACT") else S1.JPlain)(S1.jcfg(cfg).model)
    v = jax.device_get(jax.jit(lambda x: jm.init(RNGS, x))(jnp.asarray(pts)))
    v = {k: perturb(x, rng) for k, x in v.items()}
    rngs = jax_step_rngs(jax.random.PRNGKey(7), jnp.int32(0))
    rngs.pop("augment")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S1.jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
        inter = jax.jit(lambda v, p: jm.apply(v, p, TEMP, False, train=True, rngs=rngs,
                                              mutable=["batch_stats", "intermediates"])[1])(
            v, jnp.asarray(pts))["intermediates"]
    return dict(cfg=cfg, jm=jm, v=v, pts=pts, u=t(inter["gumbel_u"][0]))


def table_case():
    cfg = S1.smoke_cfg(S1.PLAIN_CFG)
    clouds = np.random.default_rng(4).normal(size=(len(TABLE_TAX), 128, 3)).astype(np.float32)
    return dict(model_cfg=dict(cfg.model), sd=build_autoencoder_model(cfg.model, 3).state_dict(),
                tax=TABLE_TAX, clouds=clouds)


class Clouds:
    """(taxonomy, id, cloud) items, as the worker's."""

    def __init__(self, tax, clouds):
        self.tax, self.clouds = tax, clouds

    def __len__(self):
        return len(self.tax)

    def __getitem__(self, i):
        return self.tax[i], str(i), self.clouds[i]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, with the cases they were computed on. The ranks
    start first and run their preemption check while the cases are built."""
    out_dir, exp = tmp_path_factory.mktemp("ranks"), str(tmp_path_factory.mktemp("runs"))
    procs = start_ranks(WORKER, out_dir, PREEMPT_CFG=repr(dict(small_run_cfg(bs=8))),
                        PREEMPT_EXP=exp)
    try:
        return dict(build_cases_and_finish(procs, out_dir), exp=exp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build_cases_and_finish(procs, out_dir):
    rng = np.random.default_rng(0)
    ft, s1, tb = finetune_case(), stage1_case(), table_case()
    bn = common.BatchNorm(6)
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            p.copy_(t(1 + 0.1 * rng.normal(size=6).astype(np.float32)))
    cases = dict(
        draw_pts=t(rng.normal(size=(8, 16, 3)).astype(np.float32)),
        draw_centers=t(rng.normal(size=(8, 8, 3)).astype(np.float32)),
        bn_sd=bn.state_dict(),
        bn_x=t((rng.normal(size=(8, 5, 6)) + 3.0).astype(np.float32)),
        bn_w=t(rng.normal(size=(8, 5, 6)).astype(np.float32)),
        gumbel_x=t(rng.normal(size=GUMBEL_SHAPE).astype(np.float32)),
        gumbel_seed=seed_tensor(),
        ft=dict(model_cfg=ft["model_cfg"], cfg=dict(ft["cfg"]), pts=t(ft["pts"]),
                labels=t(ft["labels"]), sd=F.port_model(ft["model_cfg"], ft["v"]).state_dict()),
        s1=dict(cfg=dict(s1["cfg"]), sd=S1.build(s1["cfg"], s1["v"]).state_dict(),
                pts=t(s1["pts"]), u=s1["u"], temp=TEMP, kldw=KLDW, b=S1_B // R),
        table=tb)
    return dict(cases=cases, ft=ft, s1=s1, outs=finish_ranks(procs, cases, out_dir))


# ---------------------------------------------------------------------------
# collectives, loader, draws, BatchNorm, Gumbel, table
# ---------------------------------------------------------------------------

def test_collectives_across_ranks(ranks):
    for out in ranks["outs"]:
        np.testing.assert_array_equal(out["gather"], [[0, 0], [1, 1], [1, 1]])
        assert out["gather"].dtype == np.int32
        assert list(out["gather_str"]) == ["t0", "t1", "t1"]
        assert out["mean"] == 1.5


class Indexed:
    """Each item its own index, as a (taxonomy, id, data) sample."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return "-", str(i), np.int64(i)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,replicas", [(10, 2), (11, 2), (11, 3)])
def test_loader_shards_match_jax(shuffle, n, replicas):
    """Each rank's batches equal JAX's ``DataLoader(num_replicas, rank)``
    index for index, over two epochs, with the padding of an uneven count."""
    for rank in range(replicas):
        kw = dict(batch_size=2, shuffle=shuffle, drop_last=shuffle, seed=3,
                  num_replicas=replicas, rank=rank, prefetch=0)
        port, ref = DataLoader(Indexed(n), **kw), JDataLoader(Indexed(n), **kw)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = [b[2].tolist() for b in port], [b[2].tolist() for b in ref]
            assert got == want and len(port) == len(ref) == len(got), (rank, epoch)
        assert port.num_samples() == -(-n // replicas)
        assert port.num_real() == len(range(rank, n, replicas))


def test_draws_are_the_global_draws_rows(ranks):
    """Every draw of a step on rank r is rows [4r, 4r + 4) of the same draw
    over the 8 clouds of the global batch, and the generator ends where the
    one-process draws leave it."""
    c = ranks["cases"]
    g = torch.Generator().manual_seed(5)
    pts = c["draw_pts"]
    want = [rand_local((8, 3), g), scale_and_translate(pts, g), rotate_y(pts, g),
            subset_draw(8, 10, 6, g, "cpu"), random_mask(g, 8, 8, 3),
            block_mask(g, c["draw_centers"], 3), randint_local(7, (8, 2), g),
            torch.rand(3, generator=g)]
    for r, out in enumerate(ranks["outs"]):
        for i, (got, w) in enumerate(zip(out["draws"], want)):
            w = w if i == len(want) - 1 else w[4 * r:4 * (r + 1)]
            assert torch.equal(got, w), (r, i)


def test_global_batchnorm_and_its_gradients(ranks):
    c = ranks["cases"]
    bn = common.BatchNorm(6)
    bn.load_state_dict(c["bn_sd"])
    x = c["bn_x"].clone().requires_grad_()
    y = bn.train()(x)
    (y * c["bn_w"]).sum().backward()
    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    for r, out in enumerate(ranks["outs"]):
        b = out["bn"]
        rows = slice(4 * r, 4 * (r + 1))
        close(b["y"], y.detach()[rows])
        close(b["xg"], x.grad[rows])
        close(b["rm"], bn.running_mean)
        close(b["rv"], bn.running_var)
    for name, g in (("wg", bn.weight.grad), ("bg", bn.bias.grad)):
        close(sum(out["bn"][name] for out in ranks["outs"]), g)


@pytest.mark.pallas
def test_gumbel_rank_fold_matches_the_jax_mesh_shards(ranks, interpret):
    """Rank r's plain ids equal shard r of JAX's kernel on a 2-device data
    mesh in interpret mode, on the spawned ranks and at ``fold_seed(seed, r)``
    here."""
    x = ranks["cases"]["gumbel_x"]
    want = np.asarray(j_gumbel_argmax(jnp.asarray(x.numpy()), jnp.asarray(SEED_WORDS),
                                      mesh=make_mesh(jax.devices()[:R])))
    b = x.shape[0] // R
    assert not torch.equal(ops.gumbel_argmax(x[b:], ops.sampling.fold_seed(seed_tensor(), 1)),
                           ops.gumbel_argmax(x[b:], seed_tensor()))
    for r, out in enumerate(ranks["outs"]):
        local = x[r * b:(r + 1) * b]
        folded = ops.sampling.fold_seed(seed_tensor(), r)
        here = ops.gumbel_argmax(local, folded)
        assert torch.equal(out["gumbel"], here), r
        differ = here.numpy() != want[r * b:(r + 1) * b]
        assert not (differ & ~near_tie_rows(local, folded)).any(), r


def test_stage1_table_across_ranks_equals_one_rank(ranks):
    """JAX fault (d): each process tables its own shard. The port gathers the
    clouds first: 2 ranks over 5 clouds give the one-rank table exactly."""
    tb = ranks["cases"]["table"]
    model = build_autoencoder_model(S1.smoke_cfg(S1.PLAIN_CFG).model, 3)
    model.load_state_dict(tb["sd"])
    loader = DataLoader(Clouds(tb["tax"], tb["clouds"]), 1, prefetch=0)
    metrics, rows = validate(model, loader, logger="silent")
    assert len(rows) == len(TABLE_TAX)
    for out in ranks["outs"]:
        assert out["table"]["rows"] == rows
        assert out["table"]["table"] == metrics.table


def test_two_ranks_stop_at_the_same_step(ranks):
    """Only rank 1 is asked to stop (after its 2nd step, then in ``run_net``
    after its 1st); the MAX over the ranks' flags stops rank 0 at the same
    step. The 2-rank finetune stopped there and resumed ends bit-equal to
    the uninterrupted 2-rank run; rank 0 alone wrote a cursor and both
    ranks' draw states."""
    for out in ranks["outs"]:
        got = out["preempt"]
        assert got["stop"] == 2
        assert got["cursor"] == {"epoch": 0, "next_batch": 1} and got["draw_states"] == 2
        assert got["cut"] == (True, 1) and got["steps"] == (3, 3) and got["same"]
    last = torch.load(os.path.join(ranks["exp"], "cut", "ckpt-last.pth"), weights_only=True)
    assert "data_iter" not in last and last["step"] == 3


# ---------------------------------------------------------------------------
# one train step over 2 ranks
# ---------------------------------------------------------------------------

def assert_step(got_sd, got_g, want_sd, want_g, before, frozen=(), noise=1e-6):
    """``tests/test_torch_port_train.py``'s rules for a step: statistics
    within 1e-5, gradients within 1e-4 of each tensor's largest, deltas
    within 2 ulp + 1e-3 of the reference delta wherever its gradient is at
    least 1e-6; tensors whose reference gradient is zero up to rounding
    (below ``noise`` of the largest: 1e-4 for the finetune head's cancelled
    biases, ``tests/test_torch_port_finetune.py``) only below it too."""
    g_max = max(float(g.abs().max()) for g in want_g.values())
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        w = want_g[k]
        if float(w.abs().max()) < noise * g_max:
            assert float(g.abs().max()) < noise * g_max, k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(w.abs().max()),
                                       err_msg=k)
    for k, x in got_sd.items():
        if "num_batches" in k:
            continue
        if k in got_g:
            if float(want_g[k].abs().max()) < noise * g_max:
                continue
            d = (x - before[k]).double().numpy()
            want_d = (want_sd[k] - before[k]).double().numpy()
            ulp = 2 * np.spacing(np.abs(before[k].float().numpy()))
            sure = np.abs(want_g[k].numpy()) >= 1e-6
            assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
        elif k.startswith(frozen):
            assert torch.equal(x, before[k]), k
        else:
            np.testing.assert_allclose(x.float(), want_sd[k].float(), rtol=0, atol=1e-5,
                                       err_msg=k)


def port_finetune_step(ft):
    """The one-process port step on the global batch, with the global masks."""
    with pytest.MonkeyPatch.context() as mp:
        pins = F.Pins(mp)
        model = F.port_model(ft["model_cfg"], ft["v"])
        before = {k: x.clone() for k, x in model.state_dict().items()}
        opt, schedule = builder.build_optimizer(ft["cfg"], model, 4)
        gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}
        pins.reset()
        loss, acc = finetune_step(model, opt, schedule, t(ft["pts"]), t(ft["labels"]), 0, gens,
                                  grad_norm_clip=ft["cfg"].grad_norm_clip)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return float(loss), float(acc), model.state_dict(), grads, before


def test_finetune_step_two_ranks_equals_one_rank(ranks, monkeypatch):
    ft = ranks["ft"]
    model = F.port_model(ft["model_cfg"], ft["v"])
    pins = F.Pins(monkeypatch)

    def forward():
        pins.reset()
        model.train()(t(ft["pts"]))
    assert F.pool_margin(monkeypatch, forward) >= F.MARGIN
    monkeypatch.undo()
    loss, acc, sd, grads, before = port_finetune_step(ft)
    outs = [o["ft"] for o in ranks["outs"]]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), loss, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.mean([o["acc"] for o in outs]), acc, rtol=0, atol=1e-4)
    for o in outs:
        assert_step(o["sd"], o["grads"], sd, grads, before, noise=1e-4)
    for k, x in outs[0]["sd"].items():  # the ranks stay equal
        assert torch.equal(x, outs[1]["sd"][k]), k


def test_finetune_step_two_ranks_equals_the_jax_mesh_step(ranks, monkeypatch):
    ft = ranks["ft"]
    pins = F.Pins(monkeypatch)
    jm, v, cfg = ft["jm"], ft["v"], ft["cfg"]
    params, stats = v["params"], v["batch_stats"]
    tx, _ = jbuilder.build_optimizer(cfg, params, 4, None)
    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    pins.reset()
    j_state, metrics = make_finetune_step(jm, mesh=mesh)(
        TrainState.create(v, tx), jnp.asarray(ft["pts"]), jnp.asarray(ft["labels"]),
        jax.random.PRNGKey(7))
    outs = [o["ft"] for o in ranks["outs"]]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), float(metrics["loss"]),
                               rtol=0, atol=1e-5)
    # JAX's clipped gradients from its first Adam moment, mu = (1 - b1) g
    adam = [s for s in jax.tree_util.tree_leaves(
        j_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), adam[0].mu)
    want_g = {k: g for k, g in F.as_port(mu, stats).items() if k in outs[0]["grads"]}
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_g.values())))
    np.testing.assert_allclose(norm, cfg.grad_norm_clip, rtol=1e-4)  # the clip engaged
    want_sd = F.as_port(j_state.params, jax.device_get(j_state.batch_stats))
    before = F.port_model(ft["model_cfg"], v).state_dict()
    for o in outs:
        assert_step(o["sd"], o["grads"], want_sd, want_g, before, noise=1e-4)


def port_stage1_model(s1):
    model = S1.build(s1["cfg"], s1["v"])
    builder.freeze_teacher_backbone(model, cast_bf16=False)
    return model


def test_stage1_step_two_ranks_equals_one_rank_and_the_jax_mesh_step(ranks, monkeypatch):
    s1 = ranks["s1"]
    cfg, u = s1["cfg"], s1["u"]
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    monkeypatch.setattr(S1.jcommon.FastDropout, "__call__",
                        lambda self, x, deterministic=True: x)
    model = port_stage1_model(s1)
    monkeypatch.setattr(model, "forward", functools.partial(model.forward, gumbel_u=u))
    assert S1.min_choice_gap(model, t(s1["pts"]), TEMP, KLDW, monkeypatch) > 5e-7
    before = {k: x.clone() for k, x in model.state_dict().items()}
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    gens = {n: torch.Generator() for n in STREAMS}
    loss = autoencoder_step(model, opt, schedule, t(s1["pts"]), 0, gens, TEMP, KLDW,
                            grad_norm_clip=cfg.grad_norm_clip)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    outs = [o["s1"] for o in ranks["outs"]]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs], axis=0),
                               [float(x) for x in loss], rtol=0, atol=1e-5)
    frozen = ("visual_embed.",)
    for o in outs:
        assert_step(o["sd"], o["grads"], model.state_dict(), grads, before, frozen)

    # JAX's step on a 4-device data mesh (a cloud a device)
    jm, v = s1["jm"], s1["v"]
    trainable = jbuilder.freeze_mask_from_paths(v["params"], S1.FROZEN)
    tx, _ = jbuilder.build_optimizer(S1.jcfg(cfg), v["params"], 4, trainable)
    step = make_autoencoder_step(jm, mesh=make_mesh(jax.devices()[:S1_B]),
                                 trainable_mask=trainable)
    j_state, metrics = step(TrainState.create(v, tx), jnp.asarray(s1["pts"]),
                            jax.random.PRNGKey(7), jnp.float32(TEMP), jnp.float32(KLDW))
    np.testing.assert_allclose(np.mean([o["loss"][0] for o in outs]), float(metrics["loss"]),
                               rtol=0, atol=1e-5)
    _, want_bs = S1.to_flax({k: x for k, x in outs[0]["sd"].items() if "running" in k})
    got_bs = S1.flat_np(j_state.batch_stats)
    for k, x in got_bs.items():
        np.testing.assert_allclose(want_bs[k], x, rtol=0, atol=1e-5, err_msg=k)
    deltas, _ = S1.to_flax({k: outs[0]["sd"][k] - before[k] for k in before
                            if before[k].is_floating_point() and k in grads})
    g_flax, _ = S1.to_flax(grads)
    old_p, new_p = S1.flat_np(v["params"]), S1.flat_np(j_state.params)
    for k, d in deltas.items():
        want_d = new_p[k] - old_p[k]
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        sure = np.abs(g_flax[k]) >= 1e-6
        assert (np.abs(d - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k
