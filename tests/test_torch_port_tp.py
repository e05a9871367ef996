"""The port's tensor parallelism held against one process and against the JAX package's 2-D mesh.

The ranks run in spawned processes joined by a gloo group on the CPU, laid
out by ``parallel.initialize_model_parallel(2)``: two ranks as data 1 x
model 2, and four as data 2 x model 2 (started together, once for the
module). Each rank writes what it computed (the sharded tensors gathered to
the full layout by ``tp.full_tensors``) to a file; the tests hold it
against the port's one-process step on the global batch and against JAX's
step on ``make_mesh(devices[:n], model_parallel=2)`` with
``shard_params_tp`` (the CPU devices of ``tests/conftest.py``), under
``tests/test_torch_port_train.py``'s rules: loss and statistics within
1e-5, gradients within 1e-4 of each tensor's largest (a gradient that a
batch-statistics BatchNorm cancels only below 1e-4 of the largest), AdamW
deltas within 2 f32 ulp + 1e-3 of the reference delta wherever the
reference gradient is at least 1e-6. The finetune step (B = 8, the mlp-3
head, drop path 0.3 and the head's dropouts pinned to the same numpy masks,
each data index its rows) and the Stage-I step (B = 4, the Gumbel
uniforms pinned) are the cases of ``tests/test_torch_port_dist.py``, whose
seeds clear their max-pool (and Chamfer) choices; the Stage-II step is
``tests/test_torch_port_train.py``'s (mask and Gumbel draws pinned). The
part-seg and ``ACT_PointBERT`` steps draw from the port's own generators
(one data index: the draws of one process) and are held to one process:
gradients within 1e-5 of each tensor's largest, deltas as
``tests/test_torch_port_dist_seg.py`` holds them. Replicated tensors are
bit-equal on every rank, shards on the ranks of one model index.
Checkpoints of a tensor-parallel run are the one-process file bit for bit.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from act_tpu.engine import builder as jbuilder
from act_tpu.engine.train_state import (TrainState, make_autoencoder_step, make_finetune_step,
                                        make_pretrain_step)
from act_tpu.engine.train_state import step_rngs as jax_step_rngs
from act_tpu.models import ACT_PointDistillation as JDistill
from act_tpu.models import common as jcommon
from act_tpu.parallel import make_mesh
from act_tpu.parallel.tp import shard_params_tp, tp_spec_for_path

from act_tpu_torch import ops, parallel
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import runner_finetune as rf
from act_tpu_torch.engine import runner_segmentation as rs
from act_tpu_torch.engine.runner_pretrain import freeze_tokenizer
from act_tpu_torch.engine.train_state import (STREAMS, autoencoder_step, pretrain_step,
                                              seg_step, step_rngs)
from act_tpu_torch.models import MODELS, ACT_PointBERT, ACT_PointDistillation, act, common
from act_tpu_torch.parallel import tp
from act_tpu_torch.utils.config import ConfigDict

from tests import test_torch_port_dist as D
from tests import test_torch_port_dist_seg as DS
from tests import test_torch_port_finetune as F
from tests import test_torch_port_pointbert as PB
from tests import test_torch_port_stage1 as S1
from tests import test_torch_port_teachers as TH
from tests import test_torch_port_train as T2
from tests.test_torch_port_finetune_data import small_run_cfg
from tests.test_torch_port_stage2 import jax_variables

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
TEMP, KLDW = D.TEMP, D.KLDW

# a rank's code: initialize_model_parallel(2), its share of each check, results
# to out-<rank>.pt; the checkpoint and preemption checks (2 ranks) run first,
# while the parent builds the cases
WORKER = r"""
import functools, os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO"])
torch.set_num_threads(1)
import torch.distributed as dist
r, W = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                        world_size=W, rank=r)
from act_tpu_torch import ops, parallel
from act_tpu_torch.engine import builder
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_finetune as rf
from act_tpu_torch.engine import runner_segmentation as rs
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.engine.runner_pretrain import freeze_tokenizer
from act_tpu_torch.engine.train_state import (STREAMS, autoencoder_step, finetune_step,
                                              pretrain_step, seg_step, step_rngs)
from act_tpu_torch.models import MODELS, ACT_PointBERT, ACT_PointDistillation, act, common
from act_tpu_torch.parallel import tp
from act_tpu_torch.utils.config import ConfigDict

parallel.initialize_model_parallel(2)
D, d = parallel.data_count(), parallel.data_index()
out = {"grid": (D, d, parallel.model_count(), parallel.model_index())}
rows = lambda a: a[d * (a.shape[0] // D):(d + 1) * (a.shape[0] // D)]

def result(model, loss, **extra):
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return dict(loss=loss, sd=tp.full_state_dict(model), grads=tp.full_tensors(model, grads),
                local=model.state_dict(), split=sorted(tp._split_params(model)), **extra)

if W == 2:
    # checkpoints: a save of the sharded model after 0 steps, then after 2 steps
    # with its moments; read back into a sharded model; a run stopped mid-epoch
    # and resumed against the uninterrupted one
    cfg, exp = ConfigDict(eval(os.environ["RUN_CFG"])), os.environ["RUN_EXP"]
    st = rf.build_state(cfg, 4, 0, "cpu")
    ckpt_lib.save_checkpoint(st.model, st.optimizer, 0, 0, None, None, "zero", exp)
    rf.run_finetune_steps(cfg, 2, device="cpu", state=st)
    ckpt_lib.save_checkpoint(st.model, st.optimizer, 2, 0, None, None, "two", exp)
    back = rf.build_state(cfg, 4, 5, "cpu")
    ckpt_lib.load_params_into(back.model, os.path.join(exp, "two.pth"))
    tp.load_full_optimizer_state_dict(back.optimizer, torch.load(
        os.path.join(exp, "two.pth"), weights_only=True)["optimizer"])
    want = st.optimizer.state_dict()["state"]
    got = back.optimizer.state_dict()["state"]
    out["ckpt"] = dict(
        local_shapes={n: tuple(p.shape) for n, p in st.model.named_parameters()},
        back_model=all(torch.equal(x, back.model.state_dict()[k])
                       for k, x in st.model.state_dict().items()),
        back_opt=sorted(got) == sorted(want) and all(
            torch.equal(got[i][k], v) for i in want for k, v in want[i].items()))
    whole = rf.run_net(cfg, device="cpu", epochs=1, max_steps=3, experiment_path=exp + "/whole")
    GUARD.at_step = 1
    cut = rf.run_net(cfg, device="cpu", epochs=1, max_steps=3, experiment_path=exp + "/cut")
    GUARD.reset()
    GUARD.at_step = None
    rest = rf.run_net(cfg, device="cpu", epochs=1, max_steps=2, resume=True,
                      experiment_path=exp + "/cut")
    a, b = tp.full_state_dict(whole.state.model), tp.full_state_dict(rest.state.model)
    out["preempt"] = dict(cut=(cut.preempted, cut.steps), steps=(rest.steps, whole.steps),
                          same=all(torch.equal(x, b[k]) for k, x in a.items()))

while not os.path.exists(os.environ["INPUTS"]):
    time.sleep(0.05)
inp = torch.load(os.environ["INPUTS"], weights_only=False)

# one finetune step, drop path and dropout pinned to the global masks' rows
calls = {"droppath": 0, "dropout": 0}

def mask(kind, shape, keep):
    i = calls[kind]
    calls[kind] += 1
    gshape = (shape[0] * D,) + tuple(shape[1:])
    m = np.random.default_rng([11, 0 if kind == "droppath" else 1, i]).random(gshape) < keep
    return torch.from_numpy(m[d * shape[0]:(d + 1) * shape[0]])

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

own = common.DropPath.forward, common.Dropout.forward
common.DropPath.forward, common.Dropout.forward = droppath, dropout
ft = inp["ft"]
model = MODELS.build(ConfigDict(ft["model_cfg"]))
model.load_state_dict(ft["sd"], strict=True)
tp.shard_module(model)
opt, schedule = builder.build_optimizer(ConfigDict(ft["cfg"]), model, 4)
gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}
tp.reset_traffic()
loss, acc = finetune_step(model, opt, schedule, rows(ft["pts"]), rows(ft["labels"]), 0, gens,
                          grad_norm_clip=ft["cfg"]["grad_norm_clip"])
out["ft"] = result(model, float(loss), acc=float(acc), traffic=dict(tp.TRAFFIC))
common.Dropout.forward = lambda self, x, rngs=None: x  # prompt dropout off

if W == 2:
    # one Stage-II step, the masks and the Gumbel picks pinned
    s2 = inp["s2"]
    model = ACT_PointDistillation(ConfigDict(s2["cfg"]["model"]))
    model.load_state_dict(s2["sd"], strict=True)
    builder.freeze(model, ["dvae_tokenizer"])
    tp.shard_module(model)
    opt, schedule = builder.build_optimizer(ConfigDict(s2["cfg"]), model, 4)
    act.random_mask = lambda g, B, G, n: rows(s2["mask"])
    ops.gumbel_argmax = lambda logits, seed: torch.argmax(
        logits - torch.log(-torch.log(rows(s2["u"]))), dim=-1)
    loss = pretrain_step(model, opt, schedule, rows(s2["pts"]), 0, gens, transform=None)
    out["s2"] = result(model, float(loss))

    # one Stage-I step, the Gumbel uniforms pinned
    s1 = inp["s1"]
    cfg = ConfigDict(s1["cfg"])
    model = MODELS.build(cfg.model)
    model.load_state_dict(s1["sd"], strict=True)
    builder.freeze_teacher_backbone(model, cast_bf16=False)
    tp.shard_module(model)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    fwd = model.forward
    model.forward = lambda *a, **k: fwd(*a, gumbel_u=rows(s1["u"]), **k)
    step = autoencoder_step(model, opt, schedule, rows(s1["pts"]), 0, gens, s1["temp"],
                            s1["kldw"], grad_norm_clip=cfg.grad_norm_clip)
    out["s1"] = result(model, [float(v) for v in step])
    for arch in ("clip", "bert"):  # Stage I with the other teachers
        c = inp[arch]
        cfg = ConfigDict(c["cfg"])
        model = MODELS.build(cfg.model)
        model.load_state_dict(c["sd"], strict=True)
        builder.freeze_teacher_backbone(model, cast_bf16=False)
        tp.shard_module(model)
        opt, schedule = builder.build_optimizer(cfg, model, 4)
        fwd = model.forward
        model.forward = functools.partial(fwd, gumbel_u=rows(c["u"]))
        step = autoencoder_step(model, opt, schedule, rows(c["pts"]), 0, gens, 0.5, 0.05)
        out[arch] = result(model, [float(v) for v in step])

    # one part-seg and one ACT_PointBERT step on the port's own draws
    common.DropPath.forward, common.Dropout.forward = own
    c = inp["ps"]
    st = rs.build_seg_state("partseg", 10, num_group=c["G"], dtype="f32", device="cpu",
                            widths=c["widths"])  # sharded: the grid is made
    tp.load_full_state_dict(st.model, c["sd"])
    loss = seg_step(st.model, st.optimizer, st.schedule, rows(c["pts"]), rows(c["seg"]), 0,
                    step_rngs(0, 0, "cpu"), rows(c["oh"]))
    out["ps"] = result(st.model, float(loss))
    c = inp["pb"]
    model = ACT_PointBERT(ConfigDict(c["cfg"]))
    model.load_state_dict(c["sd"])
    freeze_tokenizer(model, ConfigDict(dict(model=dict(c["cfg"], frozen_bf16=False))))
    tp.shard_module(model)
    opt, schedule = builder.build_optimizer(ConfigDict(c["train_cfg"]), model, 4)
    loss = pretrain_step(model, opt, schedule, rows(c["pts"]), 0, step_rngs(0, 0, "cpu"),
                         transform=None, ema_momentum=c["m"])
    out["pb"] = result(model, float(loss))

torch.save(out, os.path.join(os.environ["OUT"], "out-%d.pt" % r))
dist.destroy_process_group()
"""


def plain(x):
    """Configs as plain dicts and lists (the ranks import no JAX class to unpickle)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def start_ranks(world: int, out_dir, **env) -> list:
    env = {**os.environ, **env, "REPO": REPO, "INPUTS": os.path.join(out_dir, "inputs.pt"),
           "OUT": str(out_dir), "PORT": str(D.free_port()), "OMP_NUM_THREADS": "1",
           "WORLD": str(world)}
    return [subprocess.Popen([sys.executable, "-c", WORKER], env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish_ranks(procs: list, inputs: dict, out_dir, timeout: int = 300) -> list:
    path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, path + ".part")
    os.replace(path + ".part", path)
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(os.path.join(out_dir, f"out-{r}.pt"), weights_only=False)
            for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def jax_tp_state(v, tx, n_dev):
    """JAX's train state on ``make_mesh(devices[:n_dev], model_parallel=2)``,
    its params sharded by ``shard_params_tp`` before the optimizer's init."""
    mesh = make_mesh(jax.devices()[:n_dev], model_parallel=TP)
    v = {**v, "params": shard_params_tp(v["params"], mesh)}
    return mesh, TrainState.create(v, tx)


def stage2_case():
    """``tests/test_torch_port_train.py``'s Stage-II step: config, JAX
    variables, clouds, the pinned mask and Gumbel uniforms, JAX's gradient
    (one device) and JAX's step on the 2-device TP mesh."""
    rng = np.random.default_rng(0)
    cfg = T2.train_cfg(drop_path=0.0)
    jm = JDistill(cfg.model)
    pts = rng.normal(size=(4, 128, 3)).astype(np.float32)
    v = jax_variables(jm, rng, pts)
    params, stats = v["params"], v["batch_stats"]
    base = jax.random.PRNGKey(7)
    rngs = jax_step_rngs(base, jnp.int32(0))
    rngs.pop("augment")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
        (j_loss, inter), j_grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(pts), train=True, rngs=rngs,
            mutable=["batch_stats", "intermediates"]), has_aux=True))(params)
        inter = inter["intermediates"]
        trainable = jbuilder.freeze_mask_from_paths(params, ["dvae_tokenizer"])
        tx, _ = jbuilder.build_optimizer(cfg, params, 4, trainable)
        mesh, state = jax_tp_state(v, tx, 2)
        step = make_pretrain_step(jm, transform_fn=None, trainable_mask=trainable, mesh=mesh)
        j_state, metrics = step(state, jnp.asarray(pts), base)
    return dict(cfg=cfg, v=v, pts=pts, mask=D.t(inter["mask"][0]),
                u=D.t(inter["dvae_tokenizer"]["gumbel_u"][0]), j_loss=float(j_loss),
                j_grads=T2.flat_np(j_grads), j_state=jax.device_get(j_state),
                tp_loss=float(metrics["loss"]))


def teacher_case(arch):
    """``tests/test_torch_port_teachers.py``'s Stage-I step of the CLIP or
    BERT teacher: its config at 8 groups, drawn variables, clouds and
    Gumbel uniforms (its seeds clear the max-pool and Chamfer choices)."""
    cfg = TH.arch_cfg(arch, num_group=8)
    rng = np.random.default_rng(TH.STEP_SEEDS[arch])
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    u = rng.uniform(1e-10, 1.0, size=(2, 8, 64)).astype(np.float32)
    model = TH.port_dvae(arch, cfg, TH.jax_dvae(arch)[2])
    return dict(cfg=plain(cfg), sd=model.state_dict(), pts=D.t(pts), u=D.t(u))


def seg_case():
    """The narrowed part-seg model (``tests/test_torch_port_dist_seg.py``'s
    widths) from the port's seeded init, on two clouds."""
    pts, oh, seg = DS.seg_batch("partseg")
    st = rs.build_seg_state("partseg", 10, num_group=DS.SEG_G, dtype="f32", device="cpu",
                            widths=DS.WIDTHS)
    return dict(G=DS.SEG_G, widths=DS.WIDTHS, sd=st.model.state_dict(), pts=D.t(pts),
                oh=D.t(oh), seg=D.t(seg))


def pointbert_case():
    """The tiny ACT_PointBERT (MoCo on) from the port's seeded init, on 4
    clouds."""
    cfg = PB.bert_model_cfg(moco=True)
    model = ACT_PointBERT(ConfigDict(plain(cfg)))
    model.init_weights(torch.Generator().manual_seed(0))
    pts = np.random.default_rng(5).normal(size=(PB.BS, PB.NPTS, 3)).astype(np.float32)
    return dict(cfg=plain(cfg), sd=model.state_dict(), pts=D.t(pts), m=float(cfg.m),
                train_cfg=plain(PB.train_cfg(cfg)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of the 2-rank (data 1 x model 2) and the 4-rank
    (data 2 x model 2) grids, with the cases they were computed on."""
    out2, out4 = tmp_path_factory.mktemp("tp2"), tmp_path_factory.mktemp("tp4")
    exp = str(tmp_path_factory.mktemp("tp_runs"))
    procs2 = start_ranks(2, out2, RUN_CFG=repr(plain(small_run_cfg("full", bs=8))), RUN_EXP=exp)
    procs4 = start_ranks(4, out4)
    try:
        ft, s1, s2 = D.finetune_case(), D.stage1_case(), stage2_case()
        ft_in = dict(model_cfg=plain(ft["model_cfg"]), cfg=plain(ft["cfg"]), pts=D.t(ft["pts"]),
                     labels=D.t(ft["labels"]),
                     sd=F.port_model(ft["model_cfg"], ft["v"]).state_dict())
        outs4 = finish_ranks(procs4, dict(ft=ft_in), out4)
        ps, pb = seg_case(), pointbert_case()
        inputs = dict(
            ft=ft_in,
            s2=dict(cfg=plain(s2["cfg"]), pts=D.t(s2["pts"]), mask=s2["mask"], u=s2["u"],
                    sd=weights.distillation_state_dict(s2["v"]["params"],
                                                       s2["v"]["batch_stats"])),
            s1=dict(cfg=plain(s1["cfg"]), sd=S1.build(s1["cfg"], s1["v"]).state_dict(),
                    pts=D.t(s1["pts"]), u=s1["u"], temp=TEMP, kldw=KLDW),
            ps=ps, pb=pb, clip=teacher_case("clip"), bert=teacher_case("bert"))
        outs2 = finish_ranks(procs2, inputs, out2)
        return dict(ft=ft, s1=s1, s2=s2, inputs=inputs, outs2=outs2, outs4=outs4, exp=exp)
    finally:
        for p in procs2 + procs4:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# the rules, the grid and the limits
# ---------------------------------------------------------------------------

def jax_split_keys(jm, port_sd_fn, *inputs):
    """The port keys that JAX's ``tp_spec_for_path`` shards: a tree of ones
    on the sharded leaves and zeros elsewhere (``jax.eval_shape``: no init
    runs) carried through the weight bridge ``port_sd_fn``."""
    shapes = jax.eval_shape(lambda *x: jm.init(D.RNGS, *x), *map(jnp.asarray, inputs))
    marks = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, float(len(tp_spec_for_path(jax.tree_util.keystr(p))) > 0),
                             np.float32), shapes["params"])
    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes["batch_stats"])
    sd = port_sd_fn(marks, stats)
    assert all(bool((x == 1).all()) or not bool(x.any()) for x in sd.values())
    return {k for k, x in sd.items() if bool((x == 1).all()) and x.numel()}


@pytest.mark.parametrize("which", ["finetune", "stage2", "stage1"])
def test_split_rules_are_jax_rules_on_port_keys(which):
    """``tp_split`` shards exactly the port keys whose JAX counterparts
    ``tp_spec_for_path`` shards: the MLP pair and qkv/proj of the student,
    the decoder and the ViT teacher, and nothing else (not the positional
    MLPs, the FoldingNet decoder, the group encoder or the heads)."""
    if which == "finetune":
        cfg = F.tiny_cfg()
        jm, pts = F.JPointTransformer(F.JConfigDict(cfg)), np.zeros((2, F.N_PTS, 3), np.float32)
        port = MODELS.build(ConfigDict(cfg))
        fn = weights.flax_to_state_dict
    elif which == "stage2":
        cfg = T2.train_cfg(drop_path=0.0)
        jm, pts = JDistill(cfg.model), np.zeros((2, 128, 3), np.float32)
        port = ACT_PointDistillation(cfg.model)
        fn = weights.distillation_state_dict
    else:
        cfg = S1.smoke_cfg()
        jm, pts = S1.JViT(S1.jcfg(cfg).model), np.zeros((2, 128, 3), np.float32)
        port = MODELS.build(cfg.model)
        fn = weights.dvae_state_dict
    want = jax_split_keys(jm, fn, pts)
    got = {k for k in port.state_dict() if tp.tp_split(k)}
    assert got == want and got
    kinds = {k: tp.tp_split(k) for k in got}
    assert {kinds[k] for k in got if k.endswith("qkv.weight")} == {tp.HEADS}
    assert {kinds[k] for k in got if "fc2" in k or "proj" in k} == {tp.ROW}
    for k in ("encoder.first_conv.0.weight", "pos_embed.0.weight", "pos_embed.2.weight",
              "cls_head_finetune.0.weight", "blocks.blocks.0.mlp.fc2.bias",
              "blocks.blocks.0.attn.proj.bias", "dvae_tokenizer.visual_pos_embed.0.weight",
              "decoder.mlp.0.weight", "decoder.final_conv.0.weight"):
        assert tp.tp_split(k) is None, k


def test_split_rules_of_the_clip_and_bert_teachers():
    """CLIP's fused in_proj and c_fc / c_proj, BERT's query / key / value,
    intermediate and the two output denses: the same Megatron splits on
    their own key names; their norms and the teacher's projections stay
    whole."""
    for arch, n in (("clip", 6), ("bert", 10)):
        cfg = S1.smoke_cfg()
        if arch == "bert":
            cfg.model.NAME = "ACTPromptedDiscreteVAEwithBERT"
        else:
            cfg.model.visual_embed_type = "clip_ViT-B/16"
        model = MODELS.build(cfg.model)
        assert model.teacher_arch == arch
        split = {k: tp.tp_split(k) for k in model.state_dict() if tp.tp_split(k)}
        assert len(split) == n * cfg.model.visual_embed_depth, sorted(split)
        assert all(k.startswith("visual_embed.") for k in split)
        assert all("LayerNorm" not in k and "ln_" not in k for k in split)
        if arch == "clip":
            assert split["visual_embed.1.0.attn.in_proj_weight"] == tp.HEADS
            assert split["visual_embed.1.0.mlp.c_proj.weight"] == tp.ROW
            assert tp.tp_split("visual_embed.1.0.attn.out_proj.bias") is None
        else:
            assert split["visual_embed.0.layer.0.attention.self.key.bias"] == tp.COLUMN
            assert split["visual_embed.0.layer.0.attention.output.dense.weight"] == tp.ROW
            assert split["visual_embed.0.layer.0.output.dense.weight"] == tp.ROW
            assert tp.tp_split("visual_embed.0.layer.0.output.dense.bias") is None


def test_the_limits_raise():
    """T must divide the ranks (one process is a world of 1) and every
    sharded attention's heads and MLP's hidden width."""
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        parallel.initialize_model_parallel(2)
    parallel.initialize_model_parallel(1)
    assert (parallel.data_count(), parallel.data_index(), parallel.model_count(),
            parallel.model_index()) == (1, 0, 1, 0)
    model = MODELS.build(ConfigDict(F.tiny_cfg()))  # 4 heads, hidden 128
    tp.check_model_parallel(model, 2)
    with pytest.raises(ValueError, match="3 does not divide the 4 heads of Attention "
                                         "blocks.blocks.0.attn"):
        tp.check_model_parallel(model, 3)
    student = MODELS.build(ConfigDict(dict(F.tiny_cfg(), embed_dim=24, num_heads=6)))
    tp.check_model_parallel(student, 3)
    with pytest.raises(ValueError, match="4 does not divide the 6 heads"):
        tp.check_model_parallel(student, 4)


def test_every_trainer_cli_takes_the_flag_and_refuses_it_without_ranks(tmp_path, monkeypatch):
    """``--mesh_model_parallel`` is a flag of every trainer CLI; without a
    process group of T ranks the run raises before it trains (no quiet
    fall back to one process)."""
    from act_tpu_torch import main, part_segmentation, semantic_segmentation
    from act_tpu_torch.engine.preemption import GUARD
    from act_tpu_torch.utils.parser import get_args
    monkeypatch.chdir(tmp_path)
    cfg = os.path.join(REPO, "cfgs/finetune_classification/full/finetune_modelnet.yaml")
    assert get_args(["--config", cfg, "--mesh_model_parallel", "2"]).mesh_model_parallel == 2
    for cli in (part_segmentation, semantic_segmentation):
        assert cli.parse_args(["--mesh_model_parallel", "2"]).mesh_model_parallel == 2
        with pytest.raises(ValueError, match="does not divide the 1 ranks"):
            cli.main(["--mesh_model_parallel", "2", "--device", "cpu"])
    try:
        with pytest.raises(ValueError, match="does not divide the 1 ranks"):
            main.main(["--config", cfg, "--finetune_model", "--mesh_model_parallel", "2",
                       "--device", "cpu"])
    finally:
        GUARD.uninstall()
    assert not parallel.is_distributed()


def test_the_grid_and_the_shards(ranks):
    """Rank r is data index r // 2 and model index r % 2; a sharded tensor
    holds half the full one (qkv: half of each of q, k and v), a replicated
    one is whole and bit-equal on every rank, a shard on the ranks of its
    model index."""
    for world, outs in ((2, ranks["outs2"]), (4, ranks["outs4"])):
        assert [o["grid"] for o in outs] == [(world // 2, r // 2, 2, r % 2)
                                            for r in range(world)]
        split = outs[0]["ft"]["split"]
        assert split and all(o["ft"]["split"] == split for o in outs)
        full = outs[0]["ft"]["sd"]
        for k, x in outs[0]["ft"]["local"].items():
            if k in split:
                assert x.numel() * 2 == full[k].numel(), k
                for o in outs:
                    same = torch.equal(o["ft"]["local"][k], x)
                    assert same == (o["grid"][3] == 0), (k, o["grid"])
            else:
                assert all(torch.equal(o["ft"]["local"][k], x) for o in outs), k
    kind = tp.tp_split("blocks.blocks.0.attn.qkv.weight")
    full = torch.arange(24.).reshape(12, 2)
    halves = [tp._shard(full, kind, 2, m) for m in range(2)]
    assert halves[0][:, 0].tolist() == [0, 2, 8, 10, 16, 18]  # heads 0-1 of q, k, v
    assert torch.equal(tp._unshard(halves, kind), full)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def jax_finetune_step(ft, n_dev):
    """JAX's finetune step on ``make_mesh(devices[:n_dev], model_parallel=2)``:
    (loss, the updated state and the clipped gradients in the port's layout,
    the start weights)."""
    jm, v, cfg = ft["jm"], ft["v"], ft["cfg"]
    with pytest.MonkeyPatch.context() as mp:
        pins = F.Pins(mp)
        tx, _ = jbuilder.build_optimizer(cfg, v["params"], 4, None)
        mesh, state = jax_tp_state(v, tx, n_dev)
        qkv = state.params["blocks"]["blocks_0"]["attn"]["qkv"]["kernel"]
        assert tuple(qkv.sharding.spec) == (None, "model")
        pins.reset()
        j_state, metrics = make_finetune_step(jm, mesh=mesh)(
            state, jnp.asarray(ft["pts"]), jnp.asarray(ft["labels"]), jax.random.PRNGKey(7))
    adam = [s for s in jax.tree_util.tree_leaves(
        j_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), adam[0].mu)
    stats = v["batch_stats"]
    want_g = F.as_port(mu, stats)
    want_sd = F.as_port(j_state.params, jax.device_get(j_state.batch_stats))
    return float(metrics["loss"]), want_sd, want_g, F.port_model(ft["model_cfg"], v).state_dict()


@pytest.mark.parametrize("world", [2, 4])
def test_finetune_step_equals_one_process_and_the_jax_tp_mesh(ranks, world):
    """One finetune step at data 1 x model 2 and at data 2 x model 2 (each
    data index its 8 / D clouds and its rows of the pinned masks) against
    the one-process step on the 8 clouds and against JAX's step on the same
    grid of CPU devices; the clip engages."""
    ft = ranks["ft"]
    outs = [o["ft"] for o in ranks[f"outs{world}"]]
    data = world // TP
    mean_loss = np.mean([outs[TP * d]["loss"] for d in range(data)])
    loss, acc, sd, grads, before = D.port_finetune_step(ft)
    np.testing.assert_allclose(mean_loss, loss, rtol=0, atol=1e-5)
    for o in outs:
        D.assert_step(o["sd"], o["grads"], sd, grads, before, noise=1e-4)
        assert o["traffic"]["calls"] == 4 * F.tiny_cfg()["depth"]  # f and g, 2 a block each
    j_loss, want_sd, want_g, before = jax_finetune_step(ft, world)
    np.testing.assert_allclose(mean_loss, j_loss, rtol=0, atol=1e-5)
    want_g = {k: g for k, g in want_g.items() if k in outs[0]["grads"]}
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_g.values())))
    np.testing.assert_allclose(norm, ft["cfg"].grad_norm_clip, rtol=1e-4)  # the clip engaged
    for o in outs:
        D.assert_step(o["sd"], o["grads"], want_sd, want_g, before, noise=1e-4)


def assert_jax_deltas(got_sd, before, grads, to_flax, old_p, new_p):
    """The port's AdamW deltas against JAX's wherever JAX's gradient is at
    least 1e-6 (2 ulp + 1e-3 of the delta)."""
    deltas, _ = to_flax({k: got_sd[k] - before[k] for k in before
                         if before[k].is_floating_point() and k in grads})
    assert deltas
    for k, dl in deltas.items():
        want_d = new_p[k] - old_p[k]
        ulp = 2 * np.spacing(np.abs(old_p[k]))
        sure = np.abs(grads[k]) >= 1e-6
        assert (np.abs(dl - want_d) <= ulp + 1e-3 * np.abs(want_d))[sure].all(), k


def test_stage2_step_equals_one_process_and_the_jax_tp_mesh(ranks, monkeypatch):
    """One Stage-II step (the tiny ViT teacher in the tokenizer sharded as
    JAX shards it) at data 1 x model 2 against the one-process step and
    against ``make_pretrain_step`` on the 2-device TP mesh."""
    s2 = ranks["s2"]
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    monkeypatch.setattr(act, "random_mask", lambda g, B, G, n: s2["mask"])
    monkeypatch.setattr(ops, "gumbel_argmax", lambda logits, seed: torch.argmax(
        logits - torch.log(-torch.log(s2["u"])), dim=-1))
    model = ACT_PointDistillation(s2["cfg"].model)
    model.load_state_dict(ranks["inputs"]["s2"]["sd"], strict=True)
    builder.freeze(model, ["dvae_tokenizer"])
    opt, schedule = builder.build_optimizer(s2["cfg"], model, 4)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    gens = {name: torch.Generator() for name in STREAMS}
    loss = pretrain_step(model, opt, schedule, D.t(s2["pts"]), 0, gens, transform=None)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    outs = [o["s2"] for o in ranks["outs2"]]
    for o in outs:
        np.testing.assert_allclose(o["loss"], float(loss), rtol=0, atol=1e-5)
        D.assert_step(o["sd"], o["grads"], model.state_dict(), grads, before)
        assert any(k.startswith("dvae_tokenizer.visual_embed") for k in o["split"])
    np.testing.assert_allclose(s2["tp_loss"], s2["j_loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0]["loss"], s2["tp_loss"], rtol=0, atol=1e-5)
    _, got_bs = T2.to_flax({k: x for k, x in outs[0]["sd"].items() if "running" in k})
    want_bs = T2.flat_np(s2["j_state"].batch_stats)
    assert sorted(got_bs) == sorted(want_bs)
    for k, x in got_bs.items():
        np.testing.assert_allclose(x, want_bs[k], rtol=0, atol=1e-5, err_msg=k)
    grads_j = {k: g for k, g in s2["j_grads"].items() if not k.startswith("dvae_tokenizer")}
    g_max = max(np.abs(g).max() for g in grads_j.values())
    got_g, _ = T2.to_flax(outs[0]["grads"])
    for k, g in got_g.items():
        if np.abs(grads_j[k]).max() >= 1e-6 * g_max:
            np.testing.assert_allclose(g, grads_j[k], rtol=0,
                                       atol=1e-4 * np.abs(grads_j[k]).max(), err_msg=k)
    assert_jax_deltas(outs[0]["sd"], before, grads_j, T2.to_flax,
                      T2.flat_np(s2["v"]["params"]), T2.flat_np(s2["j_state"].params))


def test_stage1_step_equals_one_process_and_the_jax_tp_mesh(ranks, monkeypatch):
    """One Stage-I step (the frozen ViT teacher sharded) at data 1 x model 2
    against the one-process step and against ``make_autoencoder_step`` on
    the 2-device TP mesh."""
    s1 = ranks["s1"]
    cfg, u = s1["cfg"], s1["u"]
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    monkeypatch.setattr(S1.jcommon.FastDropout, "__call__",
                        lambda self, x, deterministic=True: x)
    model = D.port_stage1_model(s1)
    fwd = model.forward
    model.forward = lambda *a, **k: fwd(*a, gumbel_u=u, **k)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    gens = {n: torch.Generator() for n in STREAMS}
    loss = autoencoder_step(model, opt, schedule, D.t(s1["pts"]), 0, gens, TEMP, KLDW,
                            grad_norm_clip=cfg.grad_norm_clip)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    outs = [o["s1"] for o in ranks["outs2"]]
    for o in outs:
        np.testing.assert_allclose(o["loss"], [float(x) for x in loss], rtol=0, atol=1e-5)
        D.assert_step(o["sd"], o["grads"], model.state_dict(), grads, before, ("visual_embed.",))
        assert any(k.startswith("visual_embed.0.") for k in o["split"])
    jm, v = s1["jm"], s1["v"]
    trainable = jbuilder.freeze_mask_from_paths(v["params"], S1.FROZEN)
    tx, _ = jbuilder.build_optimizer(S1.jcfg(cfg), v["params"], 4, trainable)
    mesh, state = jax_tp_state(v, tx, 2)
    step = make_autoencoder_step(jm, mesh=mesh, trainable_mask=trainable)
    j_state, metrics = step(state, jnp.asarray(s1["pts"]), jax.random.PRNGKey(7),
                            jnp.float32(TEMP), jnp.float32(KLDW))
    np.testing.assert_allclose(outs[0]["loss"][0], float(metrics["loss"]), rtol=0, atol=1e-5)
    _, want_bs = S1.to_flax({k: x for k, x in outs[0]["sd"].items() if "running" in k})
    for k, x in S1.flat_np(j_state.batch_stats).items():
        np.testing.assert_allclose(want_bs[k], x, rtol=0, atol=1e-5, err_msg=k)
    g_flax, _ = S1.to_flax(grads)
    assert_jax_deltas(outs[0]["sd"], before, g_flax, S1.to_flax, S1.flat_np(v["params"]),
                      S1.flat_np(jax.device_get(j_state.params)))


@pytest.mark.parametrize("arch", TH.ARCHS)
def test_stage1_step_of_the_clip_and_bert_teachers_equals_one_process(ranks, arch, monkeypatch):
    """One Stage-I step with CLIP's fused in_proj / QuickGELU blocks or
    BERT's post-LN layers sharded (``tests/test_torch_port_teachers.py``'s
    step, prompt dropout off, the Gumbel uniforms pinned) at data 1 x model
    2 against one process."""
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)
    c = ranks["inputs"][arch]
    cfg = ConfigDict(c["cfg"])
    model = MODELS.build(cfg.model)
    model.load_state_dict(c["sd"], strict=True)
    builder.freeze_teacher_backbone(model, cast_bf16=False)
    opt, schedule = builder.build_optimizer(cfg, model, 4)
    model.forward = functools.partial(model.forward, gumbel_u=c["u"])
    before = {k: x.clone() for k, x in model.state_dict().items()}
    loss = autoencoder_step(model, opt, schedule, c["pts"], 0,
                            {n: torch.Generator() for n in STREAMS}, 0.5, 0.05)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    for o in (o[arch] for o in ranks["outs2"]):
        assert len(o["split"]) == {"clip": 6, "bert": 10}[arch] * cfg.model.visual_embed_depth
        np.testing.assert_allclose(o["loss"], [float(x) for x in loss], rtol=0, atol=1e-5)
        D.assert_step(o["sd"], o["grads"], model.state_dict(), grads, before)


def test_partseg_step_equals_one_process(ranks):
    """One f32 part-seg step (the narrowed backbone, its drop paths drawn by
    the port) at data 1 x model 2 against one process."""
    c = ranks["inputs"]["ps"]
    st = rs.build_seg_state("partseg", 10, num_group=c["G"], dtype="f32", device="cpu",
                            widths=c["widths"])
    st.model.load_state_dict(c["sd"])
    before = {k: x.clone() for k, x in st.model.state_dict().items()}
    loss = seg_step(st.model, st.optimizer, st.schedule, c["pts"], c["seg"], 0,
                    step_rngs(0, 0, "cpu"), c["oh"])
    grads = {n: p.grad.clone() for n, p in st.model.named_parameters() if p.requires_grad}
    cancelled = DS.CANCELLED | {"label_conv.0.weight"}
    for o in (o["ps"] for o in ranks["outs2"]):
        np.testing.assert_allclose(o["loss"], float(loss), rtol=1e-6)
        DS.assert_grads_close(o["grads"], grads, cancelled)
        DS.assert_steps_close(o["sd"], st.model.state_dict(), before, grads, cancelled)
        for k, x in o["sd"].items():
            if "running" in k:
                np.testing.assert_allclose(x, st.model.state_dict()[k], rtol=1e-6, atol=1e-6)


def test_pointbert_step_equals_one_process(ranks):
    """One f32 ACT_PointBERT step at data 1 x model 2 (q and k sharded
    alike; k's EMA on the shards) against one process: gradients, AdamW
    deltas, k's EMA, the running statistics, the queue and its pointer."""
    c = ranks["inputs"]["pb"]
    model = ACT_PointBERT(ConfigDict(c["cfg"]))
    model.load_state_dict(c["sd"])
    freeze_tokenizer(model, ConfigDict(dict(model=dict(c["cfg"], frozen_bf16=False))))
    opt, schedule = builder.build_optimizer(ConfigDict(c["train_cfg"]), model, 4)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    loss = pretrain_step(model, opt, schedule, c["pts"], 0, step_rngs(0, 0, "cpu"),
                         transform=None, ema_momentum=c["m"])
    after = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    noise = {"transformer_q.encoder.first_conv.3.bias"}
    for o in (o["pb"] for o in ranks["outs2"]):
        assert any(k.startswith("transformer_k.") for k in o["split"])
        np.testing.assert_allclose(o["loss"], float(loss), rtol=1e-6)
        DS.assert_grads_close(o["grads"], grads, noise)
        DS.assert_steps_close(o["sd"], after, before, grads, noise)
        for k, x in o["sd"].items():
            if k.startswith("transformer_k.") and "running" not in k and "num_batches" not in k:
                np.testing.assert_allclose(x, after[k], rtol=0, atol=1e-6, err_msg=k)
            elif "running" in k or k == "queue":
                np.testing.assert_allclose(x, after[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert int(o["sd"]["queue_ptr"]) == int(after["queue_ptr"]) == PB.BS


# ---------------------------------------------------------------------------
# checkpoints and preemption
# ---------------------------------------------------------------------------

def test_tp_checkpoint_is_the_one_process_file(ranks):
    """A save of the sharded model after 0 steps is the one-process state
    dict key for key and bit for bit; after 2 steps it loads strictly into a
    model without a group, its Adam moments (whole) into a one-process
    AdamW, and back into a sharded model and optimizer bit for bit, whose
    own state the save left as it was."""
    cfg = small_run_cfg("full", bs=8)
    one = rf.build_state(cfg, 4, 0, "cpu")
    zero = torch.load(os.path.join(ranks["exp"], "zero.pth"), weights_only=True)
    want = one.model.state_dict()
    assert list(zero["base_model"]) == list(want)
    assert all(torch.equal(x, want[k]) for k, x in zero["base_model"].items())
    two = torch.load(os.path.join(ranks["exp"], "two.pth"), weights_only=True)
    one.model.load_state_dict(two["base_model"], strict=True)
    one.optimizer.load_state_dict(two["optimizer"])
    got = ranks["outs2"][0]["ckpt"]
    for o in ranks["outs2"]:
        assert o["ckpt"]["back_model"] and o["ckpt"]["back_opt"]
    halved = [k for k, s in got["local_shapes"].items() if tuple(want[k].shape) != s]
    assert halved and all(tp.tp_split(k) for k in halved)
    params = [q for g in one.optimizer.param_groups for q in g["params"]]
    assert len(two["optimizer"]["state"]) == len(params)  # every parameter trains
    for i, st in two["optimizer"]["state"].items():
        assert st["exp_avg"].shape == params[int(i)].shape and st["exp_avg"].abs().sum() > 0


def test_tp_run_stopped_and_resumed_equals_the_uninterrupted_run(ranks):
    """``run_net`` over the 2-rank TP grid stopped by the preemption flag
    after its first step and resumed ends bit-equal to the uninterrupted
    TP run (full layout)."""
    for o in ranks["outs2"]:
        got = o["preempt"]
        assert got["cut"] == (True, 1) and got["steps"] == (3, 3) and got["same"]
