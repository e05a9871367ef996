"""``tools/convert_checkpoint_to_torch.py``, the JAX -> port checkpoint bridge,
held against the JAX package on the CPU at narrow widths.

- Weights, every model family (PointTransformer with the mlp-3 and the
  linear head, ACT_PointDistillation, ACT_PointBERT with its queue and
  ``queue_ptr``, the ViT, CLIP and BERT dVAEs, part and semantic
  segmentation): JAX variables, frozen leaves cast to bf16 as the JAX
  runners store them, saved with the optimizer state of the JAX runner's
  transformation by ``act_tpu.engine.checkpoint.save_checkpoint``, bridged,
  loaded strictly into a port model of the same config: its eval forward
  equals JAX's ``apply`` in f32 within rtol 1e-4, atol 1e-5 (the Gumbel
  draws of the dVAE's forward replayed from JAX's sown uniforms); the
  bridged optimizer holds a state for exactly its parameters.
- Resume: JAX takes finetune steps on one batch and saves ckpt-last with a
  mid-epoch cursor; the port resumes the bridged file and both take the
  next step on the same batch (drop paths and dropouts pinned, ``Pins``).
  The state at the resume equals JAX's exactly (params, statistics,
  moments, counts); after the step the parameters are within 1e-5 and each
  moment within 2e-5 of its tensor's largest (the gradients' own tolerance
  in ``tests/test_torch_port_finetune.py``; the rounding-level gradients of
  ``CANCELLED`` within 1e-4 of the model's largest, and AdamW's step of
  their weights, about lr either way, within 2 lr more), the lr is optax's.
  AdamW inside the CosLR warmup, SGD with StepLR, and AdamW with
  ``step_per_update`` 2 saved between updates.
- The Stage-I chain: a JAX Stage-I file bridged with ``--weights_only`` is
  read by the port's ``load_dvae_ckpt`` with every tokenizer key, and its
  tokens equal JAX's ``forward_tokenizer``.
- A legacy file (per-block stacks, the conv biases before the fold) converts
  its weights and drops its moments with the printed line; a config whose
  model differs from the file raises and names a key.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import __graft_entry__ as graft
from act_tpu import ops as jops
from act_tpu.engine import builder as jbuilder
from act_tpu.engine import checkpoint as jckpt
from act_tpu.engine.train_state import TrainState, make_finetune_step
from act_tpu.models import MODELS as JMODELS
from act_tpu.models.point_transformer import trainable_mask
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import ops
from act_tpu_torch.engine import checkpoint as ckpt_lib, runner_finetune
from act_tpu_torch.engine import runner_pretrain, runner_segmentation
from act_tpu_torch.engine.serve import build_features_fn, load_seg_model, seg_config
from act_tpu_torch.engine.train_state import STREAMS, finetune_step
from act_tpu_torch.models import MODELS
from act_tpu_torch.utils.config import ConfigDict
from tools import convert_checkpoint_to_torch as bridge

from tests.test_torch_port_dist_seg import SEG_G, WIDTHS, jax_seg_model
from tests.test_torch_port_finetune import (ATOL, CANCELLED, Pins, as_port, centre_head,
                                            clouds, jax_model, tiny_cfg, train_cfg)
from tests.test_torch_port_finetune import B as FT_B
from tests.test_torch_port_finetune import CLS as FT_CLS
from tests.test_torch_port_finetune import STEP_SEED
from tests.test_torch_port_model import RNGS, perturb
from tests.test_torch_port_stage1 import VIT_CFG, smoke_cfg
from tests.test_torch_port_teachers import arch_cfg, drawn_variables
from tests.test_torch_port_tp import plain

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

RTOL, FWD_ATOL = 1e-4, 1e-5
MOMENT_TOL = 2e-5
N_PTS = 128
FAMILIES = ("pt_mlp3", "pt_linear", "distill", "pointbert", "dvae_vit", "dvae_clip",
            "dvae_bert", "partseg", "semseg")


def t(a):
    return torch.from_numpy(np.array(a))


def no_base(x):
    """A config mapping without the ``_base_`` nodes its loader keeps."""
    if isinstance(x, dict):
        return {k: no_base(v) for k, v in x.items() if k != "_base_"}
    return x


def write_yaml(path, cfg) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(no_base(plain(dict(cfg))), f)
    return str(path)


def schedule_cfg():
    return dict(optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
                scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
                grad_norm_clip=10, total_bs=4)


def family_cfg(name):
    """(the run's config as a mapping, or None for a segmentation model, and
    the model config)."""
    if name.startswith("pt_"):
        m = dict(NAME="PointTransformer", embed_dim=32, depth=2, drop_path_rate=0.0,
                 cls_dim=10, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
                 transfer_type="full" if name == "pt_mlp3" else "linear")
        return dict(model=m, npoints=N_PTS, **schedule_cfg()), m
    if name in ("distill", "pointbert"):
        m = plain(dict(graft._pretrain_cfg(tiny=True)))
        m["transformer_config"]["drop_path_rate"] = 0.0
        if name == "pointbert":
            m.update(NAME="ACT_PointBERT", m=0.999, T=0.07, K=8)
            m["transformer_config"].update(mask_ratio=[0.25, 0.45], moco_loss=True,
                                           dvae_loss=True, cutmix_loss=True)
        return dict(model=m, dataset=dict(train=dict(others=dict(npoints=N_PTS))),
                    **schedule_cfg()), m
    if name.startswith("dvae_"):
        arch = name.split("_")[1]
        cfg = smoke_cfg(VIT_CFG) if arch == "vit" else arch_cfg(arch)
        cfg.grad_norm_clip = None
        return plain(dict(cfg)), plain(dict(cfg.model))
    return None, dict(NAME="PartSegTransformer" if name == "partseg" else "SemSegTransformer")


def runner_variables(name, jm, rng, pts, oh):
    """JAX variables as the family's runner stores them: drawn, perturbed,
    frozen tokenizer / teacher blocks cast to bf16 (``cast_frozen_bf16``)."""
    inputs = (pts,) if oh is None else (pts, oh)
    if name.startswith("dvae_"):
        v = drawn_variables(jm, rng, *inputs)
    else:
        v = jax.device_get(jax.jit(lambda *x: jm.init(RNGS | dict(gumbel=RNGS["params"],
                                                                   mask=RNGS["params"]), *x))(
            *map(jnp.asarray, inputs)))
        v = {k: x if k == "buffers" else perturb(x, rng) for k, x in v.items()}
    if name in ("distill", "pointbert"):
        tok = "dvae" if name == "pointbert" else "dvae_tokenizer"
        v["params"] = jax.device_get(jbuilder.cast_frozen_bf16(v["params"], [tok]))
    elif name.startswith("dvae_"):
        v["params"] = jax.device_get(jbuilder.cast_frozen_bf16(
            v["params"], ["visual_embed']['blocks_"]))
    return v


def runner_tx(name, jcfg, params):
    """The family's optax transformation, as its JAX runner builds it."""
    if name.startswith("pt_"):
        tr = trainable_mask(params, jcfg.model.transfer_type)
        return jbuilder.build_optimizer(jcfg, params, 1, None if name == "pt_mlp3" else tr)[0]
    if name in ("distill", "pointbert"):
        frozen = ["dvae", "transformer_k"] if name == "pointbert" else ["dvae_tokenizer"]
        return jbuilder.build_optimizer(jcfg, params, 1,
                                        jbuilder.freeze_mask_from_paths(params, frozen))[0]
    if name.startswith("dvae_"):
        frozen = ["visual_embed']['blocks_", "visual_embed']['norm"]
        return jbuilder.build_optimizer(jcfg, params, 1,
                                        jbuilder.freeze_mask_from_paths(params, frozen))[0]
    return optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(1e-3, weight_decay=0.05))


def save_jax(state, path, epoch=0, best=None, data_iter=None):
    args = type("Args", (), {"experiment_path": str(path)})
    jckpt.save_checkpoint(state, epoch, {"acc": 1.0}, best or {"acc": 2.0}, "ckpt-last", args,
                          block=True, data_iter=data_iter)
    return os.path.join(str(path), "ckpt-last")


@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_bridges_to_a_strict_load_and_jax_forward(name, tmp_path, monkeypatch):
    rng = np.random.default_rng(FAMILIES.index(name))
    run_cfg, mcfg = family_cfg(name)
    seg = name in ("partseg", "semseg")
    pts = rng.normal(size=(2, N_PTS, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[[2, 9]] if name == "partseg" else None
    if seg:
        jm = jax_seg_model(name, monkeypatch)  # narrowed; the bridge builds the same
        jcfg = None
    else:
        jcfg = JConfigDict(run_cfg)
        jm = JMODELS.build(jcfg.model)
    v = runner_variables(name, jm, rng, pts, oh)
    state = TrainState.create(v, runner_tx(name, jcfg, v["params"]))
    src = save_jax(state, tmp_path / "jax")
    dst = str(tmp_path / "port" / "ckpt-last.pth")
    if seg:  # the port's model narrowed as the JAX one is
        monkeypatch.setattr(runner_segmentation, "load_seg_model",
                            lambda *a, widths=None, **kw: load_seg_model(*a, widths=WIDTHS, **kw))
        out = bridge.convert(src, dst, model=mcfg["NAME"], num_group=SEG_G)
        model = MODELS.build(seg_config(name, SEG_G, "f32", WIDTHS))
    else:
        out = bridge.convert(src, dst, config=write_yaml(tmp_path / "run.yaml", run_cfg))
        model = MODELS.build(ConfigDict(mcfg))
    assert torch.load(dst, weights_only=True).keys() == out.keys()
    model.load_state_dict(out["base_model"], strict=True)
    model.eval()
    opt = out["optimizer"]
    n_state = len(opt["state"])
    n_params = sum(len(g["params"]) for g in opt["param_groups"])
    assert n_state == n_params > 0

    # JAX's forward in f32 on the stored values (bf16 leaves upcast), as the port's
    # f32 model runs them
    jv = {k: x if k == "buffers" else jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), x) for k, x in v.items()}
    with torch.no_grad():
        if name.startswith("pt_"):
            want = jax.jit(lambda v, x: jm.apply(v, x))(jv, pts)
            got = model(t(pts))
        elif name in ("distill", "pointbert"):
            want = jax.jit(lambda v, x: jm.apply(v, x, noaug=True, rngs=RNGS))(jv, pts)
            got = build_features_fn(model, N_PTS)(pts)
        elif name.startswith("dvae_"):
            def fwd(v, x):
                ret, inter = jm.apply(v, x, 1.0, True, rngs=RNGS, mutable=["intermediates"])
                return ret, inter["intermediates"]["gumbel_u"][0]
            rets, u = jax.jit(fwd)(jv, pts)
            outs = model(t(pts), 1.0, True, gumbel_u=t(u))
            for g, w in zip(outs, rets):
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                           rtol=RTOL, atol=FWD_ATOL)
            return
        else:
            inputs = (pts,) if oh is None else (pts, oh)
            want = jax.jit(lambda v, *x: jm.apply(v, *x))(jv, *inputs)
            got = model(*map(t, inputs))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=FWD_ATOL)
    if name == "pointbert":
        assert torch.equal(out["base_model"]["queue"], t(v["buffers"]["queue"]).float())
        assert out["base_model"]["queue_ptr"].dtype == torch.long
        assert int(out["base_model"]["queue_ptr"]) == int(np.asarray(v["buffers"]["queue_ptr"]))


# ---------------------------------------------------------------------------
# resume: JAX's next step against the port's, from the bridged ckpt-last
# ---------------------------------------------------------------------------

RESUME = {  # case -> (optimizer, scheduler, step_per_update, JAX steps before the save)
    "adamw": (dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
              dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)), 1, 2),
    "sgd": (dict(type="SGD", kwargs=dict(lr=0.01, weight_decay=1e-4)),
            dict(type="StepLR", kwargs=dict(step_size=1, gamma=0.7)), 1, 2),
    "adamw_k2": (dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
                 dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)), 2, 3),
}
SPE = 4  # steps an epoch of the schedules


def moments(opt_state):
    """{kind: params-shaped tree} of the optax state."""
    out = {}
    for s in bridge._find(opt_state, optax.ScaleByAdamState):
        out.update(exp_avg=s.mu, exp_avg_sq=s.nu)
    for s in bridge._find(opt_state, optax.TraceState):
        out["momentum_buffer"] = s.trace
    for s in bridge._find(opt_state, optax.MultiStepsState):
        out["acc"] = s.acc_grads
    return out


def port_moments(model, optimizer):
    inner = getattr(optimizer, "inner", optimizer)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for g in inner.param_groups:
        for p in g["params"]:
            for k, x in inner.state.get(p, {}).items():
                if k != "step":
                    out.setdefault(k, {})[names[id(p)]] = x
    if hasattr(optimizer, "acc"):
        order = [names[id(p)] for g in inner.param_groups for p in g["params"]]
        out["acc"] = dict(zip(order, optimizer.acc))
    return out


def assert_moments(model, optimizer, j_state, stats, exact):
    got, want = port_moments(model, optimizer), moments(j_state.opt_state)
    assert set(got) == set(want)
    for kind, tree in want.items():
        w = as_port(tree, stats)
        big = max(float(x.abs().max()) for k, x in w.items() if k in got[kind])
        for k, g in got[kind].items():
            if exact:
                assert torch.equal(g, w[k]), (kind, k)
            elif k in CANCELLED:
                assert float((g - w[k]).abs().max()) <= 1e-4 * big, (kind, k)
            else:
                np.testing.assert_allclose(g.numpy(), w[k].numpy(), rtol=0,
                                           atol=MOMENT_TOL * float(w[k].abs().max()) + 1e-30,
                                           err_msg=f"{kind} {k}")


@pytest.mark.parametrize("case", list(RESUME))
def test_jax_run_resumes_in_the_port_to_jax_next_step(case, tmp_path, monkeypatch):
    opt_cfg, sche_cfg, every_k, n_saved = RESUME[case]
    rng = np.random.default_rng(STEP_SEED)
    pins = Pins(monkeypatch)
    cfg_m = tiny_cfg("full")
    cfg = train_cfg(cfg_m)
    cfg.optimizer, cfg.scheduler = ConfigDict(opt_cfg), ConfigDict(sche_cfg)
    cfg.step_per_update = every_k
    jm, v = jax_model(cfg_m, rng)
    pts = clouds(rng)
    labels = rng.integers(0, FT_CLS, FT_B).astype(np.int32)
    v = centre_head(cfg_m, v, pts, pins)
    jcfg = JConfigDict(plain(dict(cfg)))
    tx, jschedule = jbuilder.build_optimizer(jcfg, v["params"], SPE, None)
    j_state = TrainState.create(v, tx)
    j_step = make_finetune_step(jm)
    for i in range(n_saved):
        pins.reset()
        j_state, _ = j_step(j_state, jnp.asarray(pts), jnp.asarray(labels),
                            jax.random.PRNGKey(i))
    j_state = jax.device_get(j_state)
    src = save_jax(j_state, tmp_path / "jax", epoch=0, best={"acc": 12.5},
                   data_iter={"next_batch": n_saved})
    exp = tmp_path / "port"
    bridge.convert(src, str(exp / "ckpt-last.pth"),
                   config=write_yaml(tmp_path / "run.yaml", cfg))

    st = runner_finetune.build_state(cfg, SPE, 0, "cpu")
    start_epoch, step, best, start_batch = ckpt_lib.resume_state(st.model, st.optimizer,
                                                                 str(exp))
    assert (start_epoch, step, best, start_batch) == (0, n_saved, {"acc": 12.5}, n_saved)
    stats = jax.device_get(j_state.batch_stats)
    want = as_port(j_state.params, stats)
    for k, x in st.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(x, want[k]), k
    assert_moments(st.model, st.optimizer, j_state, stats, exact=True)
    if every_k > 1:
        ms = bridge._find(j_state.opt_state, optax.MultiStepsState)[0]
        assert (st.optimizer.mini_step, st.optimizer.updates) == (
            int(ms.mini_step), int(ms.gradient_step)) == (1, 1)

    pins.reset()
    j_next, _ = j_step(j_state, jnp.asarray(pts), jnp.asarray(labels),
                       jax.random.PRNGKey(n_saved))
    j_next = jax.device_get(j_next)
    gens = {n: torch.Generator().manual_seed(0) for n in STREAMS}
    pins.reset()
    finetune_step(st.model, st.optimizer, st.schedule, torch.from_numpy(pts),
                  torch.from_numpy(labels), step, gens, grad_norm_clip=cfg.grad_norm_clip)
    index = n_saved if every_k == 1 else n_saved // every_k
    lr = st.optimizer.param_groups[0]["lr"]
    assert abs(lr - float(jschedule(index))) <= 1e-7 * float(opt_cfg["kwargs"]["lr"])
    stats = jax.device_get(j_next.batch_stats)
    want = as_port(j_next.params, stats)
    for k, x in st.model.state_dict().items():
        if "num_batches" not in k:
            # Adam moves a weight whose gradient is rounding noise by about lr either way
            tol = ATOL + (2 * lr if k in CANCELLED and opt_cfg["type"] == "AdamW" else 0.0)
            np.testing.assert_allclose(x.numpy(), want[k].numpy(), rtol=0, atol=tol,
                                       err_msg=k)
    assert_moments(st.model, st.optimizer, j_next, stats, exact=False)


# ---------------------------------------------------------------------------
# the Stage-I chain, a legacy file, a mismatch
# ---------------------------------------------------------------------------

def test_stage_one_file_drives_the_stage_two_tokenizer(tmp_path):
    """A JAX Stage-I file bridged with ``--weights_only``: the port's
    ``load_dvae_ckpt`` reads every tokenizer key of it, and the tokens equal
    JAX's ``forward_tokenizer``."""
    rng = np.random.default_rng(5)
    s1 = smoke_cfg(VIT_CFG)
    jcfg = JConfigDict(plain(dict(s1)))
    jm = JMODELS.build(jcfg.model)
    pts = rng.normal(size=(2, N_PTS, 3)).astype(np.float32)
    v = runner_variables("dvae_vit", jm, rng, pts, None)
    src = save_jax(TrainState.create(v, runner_tx("dvae_vit", jcfg, v["params"])),
                   tmp_path / "s1")
    dst = str(tmp_path / "dvae.pth")
    out = bridge.convert(src, dst, config=write_yaml(tmp_path / "s1.yaml", s1),
                         weights_only=True)
    assert set(torch.load(dst, weights_only=True)) == {"base_model"} == set(out)

    s2 = plain(dict(graft._pretrain_cfg(tiny=True)))
    s2["dvae_config"] = plain(dict(s1.model))
    s2["dvae_config"]["ckpt"] = dst
    s2_cfg = ConfigDict(s2)
    model = runner_pretrain.build_pretrain_model(s2_cfg, 0)
    n = runner_pretrain.load_dvae_ckpt(model, s2_cfg.dvae_config)
    assert n == len(model.dvae_tokenizer.state_dict())
    G, M = int(s1.model.num_group), int(s1.model.group_size)
    nbr, center = jops.group_points(jnp.asarray(pts), G, M)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, method=jm.forward_tokenizer))(
        v, nbr, center)
    with torch.no_grad():
        got = model.eval().dvae_tokenizer.forward_tokenizer(*ops.group_points(t(pts), G, M))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_legacy_file_converts_weights_and_drops_moments(tmp_path, capsys):
    """Per-block stacks and the encoder's conv1/conv3 biases (before the
    fold) against a scanned config: the biases fold into the BatchNorm
    means (exact in eval), the port's conv biases come back zero, and the
    optimizer starts empty, with the printed line."""
    rng = np.random.default_rng(6)
    m_cfg = tiny_cfg("full")
    jm, v = jax_model(m_cfg, rng)  # per-block stacks (scan False)
    enc = v["params"]["encoder"]
    b1 = rng.normal(size=enc["conv1"]["kernel"].shape[-1]).astype(np.float32)
    b3 = rng.normal(size=enc["conv3"]["kernel"].shape[-1]).astype(np.float32)
    legacy = jax.tree_util.tree_map(np.asarray, v)
    legacy["params"]["encoder"]["conv1"]["bias"] = b1
    legacy["params"]["encoder"]["conv3"]["bias"] = b3
    src = save_jax(TrainState.create(legacy, optax.adamw(1e-3)), tmp_path / "jax", epoch=4)
    cfg = train_cfg(dict(m_cfg, scan=True))
    out = bridge.convert(src, str(tmp_path / "p.pth"),
                         config=write_yaml(tmp_path / "run.yaml", cfg))
    assert "REINITIALIZED the optimizer moments" in capsys.readouterr().out
    assert out["optimizer"]["state"] == {} and out["epoch"] == 4
    sd = out["base_model"]
    bs = v["batch_stats"]["encoder"]
    np.testing.assert_array_equal(sd["encoder.first_conv.1.running_mean"].numpy(),
                                  np.asarray(bs["bn1"]["mean"]) - b1)
    np.testing.assert_array_equal(sd["encoder.second_conv.1.running_mean"].numpy(),
                                  np.asarray(bs["bn2"]["mean"]) - b3)
    assert not sd["encoder.first_conv.0.bias"].any()
    for k, x in as_port(v["params"], jax.device_get(v["batch_stats"])).items():
        if "running_mean" not in k and "num_batches" not in k:
            assert torch.equal(sd[k], x), k


def test_a_config_of_another_model_raises_naming_a_key(tmp_path):
    rng = np.random.default_rng(7)
    jm, v = jax_model(tiny_cfg("full"), rng)  # the mlp-3 head
    src = save_jax(TrainState.create(v, optax.adamw(1e-3)), tmp_path / "jax")
    cfg = train_cfg(tiny_cfg("linear"))
    with pytest.raises(ValueError, match="cls_head_finetune"):
        bridge.convert(src, str(tmp_path / "p.pth"),
                       config=write_yaml(tmp_path / "run.yaml", cfg))
