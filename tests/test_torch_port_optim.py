"""The port's optimizers, schedules and gradient accumulation held against the
JAX builder (optax) on the CPU, and the runners' ``--val_freq`` and writer.

A small parameter set (a decayed matrix, a bias, a 1-D scale, a 2-D 'token'
tensor and a frozen matrix) takes the same gradients in both packages for 8
steps: ``act_tpu.engine.builder.build_optimizer`` applied through
``tx.update`` and ``optax.apply_updates``, against
``act_tpu_torch.engine.builder.build_optimizer`` applied through
``train_state._update`` (the trainers' own update). The gradients of some
steps are large enough for the clip and some are not. Every schedule
(CosLR, LambdaLR, StepLR, function) with every optimizer (AdamW, RAdam,
Adam, SGD), and ``step_per_update`` 2 and 3 (optax ``MultiSteps``) with
each optimizer: every parameter within 1e-6 (absolute; the parameters are
O(1), lr 0.01) of optax's after every step, the frozen one bit-unchanged.
The schedules themselves are held within 1e-7 of the base lr at every
step (JAX computes them in f32, the port in f64).

A finetune ``run_net`` with SGD, StepLR and ``step_per_update`` 2,
preempted after step 3 (between the updates) and resumed, ends bit-equal to
the uninterrupted run: the weights, the momentum buffers, the accumulated
gradients and both counts.

``--val_freq``: the finetune, Stage-II and Stage-I ``run_net`` validate (or
probe) after exactly the epochs with ``epoch % val_freq == 0``, as the JAX
runners gate them; the Stage-II and Stage-I writers get the JAX runners'
scalars (the step's loss and lr, the reconstruction loss x1000) at batch 0 of
each epoch into a recording writer; ``get_writer`` gives rank 0 a
``SummaryWriter`` where it imports and a null writer otherwise; the CLIs pass
both on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from act_tpu.engine import builder as jbuilder
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch.engine import builder, runner_finetune
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.engine.train_state import _update
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_finetune_data import small_run_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

STEPS, SPE, LR, WD, CLIP = 8, 2, 0.01, 0.05, 1.0
ATOL = 1e-6
SHAPES = {"w": (4, 3), "bias": (3,), "scale": (5,), "cls_token": (1, 3), "frozen": (3, 3)}
SCHEDULES = {
    "CosLR": dict(epochs=4, initial_epochs=1),
    "LambdaLR": dict(lr_decay=0.7, decay_step=1, lowest_decay=0.3),
    "StepLR": dict(step_size=2, gamma=0.5),
    "function": dict(),
}
OPTIMIZERS = ("AdamW", "RAdam", "Adam", "SGD")


def cfg_dict(opt, sche, every_k=1):
    return dict(optimizer=dict(type=opt, kwargs=dict(lr=LR, weight_decay=WD)),
                scheduler=dict(type=sche, kwargs=SCHEDULES[sche]),
                grad_norm_clip=CLIP, step_per_update=every_k)


class Params(nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))
        self.frozen.requires_grad_(False)


def draws(seed=0):
    """The start values and the gradients of each step: steps 1, 4 and 5
    small enough to pass the clip, the others clipped."""
    r = np.random.default_rng(seed)
    values = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(STEPS):
        scale = 0.02 if i in (1, 4, 5) else 1.0
        grads.append({k: (r.normal(size=s) * scale).astype(np.float32)
                      for k, s in SHAPES.items()})
    return values, grads


def jax_run(cfg, values, grads):
    params = {k: jnp.asarray(v) for k, v in values.items()}
    trainable = {k: k != "frozen" for k in values}
    tx, sched = jbuilder.build_optimizer(JConfigDict(cfg), params, SPE, trainable)
    state = tx.init(params)

    @jax.jit
    def step(params, state, g):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state
    out = []
    for g in grads:
        params, state = step(params, state, {k: jnp.asarray(v) for k, v in g.items()})
        out.append(jax.device_get(params))
    return out, sched


def port_run(cfg, values, grads):
    model = Params(values)
    opt, sched = builder.build_optimizer(ConfigDict(cfg), model, SPE)
    out = []
    for step, g in enumerate(grads):
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[n].copy())
        _update(opt, sched, step, CLIP)
        out.append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    return out, opt, sched


def assert_same_run(cfg):
    values, grads = draws()
    want, _ = jax_run(cfg, values, grads)
    got, _, _ = port_run(cfg, values, grads)
    for step, (w, g) in enumerate(zip(want, got)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0, atol=ATOL,
                                       err_msg=f"step {step} {k}")
        assert np.array_equal(g["frozen"], values["frozen"])
    return got


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("sche", list(SCHEDULES))
def test_optimizer_and_schedule_match_optax(opt, sche):
    got = assert_same_run(cfg_dict(opt, sche))
    assert not np.array_equal(got[-1]["w"], got[-2]["w"])


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("every_k", [2, 3])
def test_step_per_update_matches_optax_multisteps(opt, every_k):
    """The weights move on every k-th step only, to optax's values."""
    got = assert_same_run(cfg_dict(opt, "StepLR" if every_k == 2 else "CosLR", every_k))
    values, _ = draws()
    prev = values
    for step, g in enumerate(got):
        moved = not np.array_equal(g["w"], prev["w"])
        assert moved == ((step + 1) % every_k == 0), step
        prev = g


@pytest.mark.parametrize("sche", ["CosLR", "LambdaLR", "StepLR", "function"])
def test_schedules_match_jax(sche):
    cfg = cfg_dict("AdamW", sche)
    want = jbuilder.build_schedule(JConfigDict(cfg["scheduler"]),
                                   JConfigDict(cfg["optimizer"]["kwargs"]), SPE)
    got = builder.build_schedule(ConfigDict(cfg), SPE)
    for step in range(0, 12):
        assert abs(got(step) - float(want(step))) <= 1e-7 * LR, step


def test_unknown_types_raise_as_in_jax():
    model = Params(draws()[0])
    for opt, sche in (("LAMB", "CosLR"), ("AdamW", "OneCycle")):
        cfg = cfg_dict(opt, "CosLR")
        cfg["scheduler"]["type"] = sche
        with pytest.raises(NotImplementedError):
            jbuilder.build_optimizer(JConfigDict(cfg), {"w": jnp.zeros((2, 2))}, SPE)
        with pytest.raises(NotImplementedError):
            builder.build_optimizer(ConfigDict(cfg), model, SPE)


def test_adam_ignores_weight_decay_and_sgd_decays_every_trainable_tensor():
    model = Params(draws()[0])
    adam, _ = builder.build_optimizer(ConfigDict(cfg_dict("Adam", "function")), model, SPE)
    sgd, _ = builder.build_optimizer(ConfigDict(cfg_dict("SGD", "function")), model, SPE)
    assert [g["weight_decay"] for g in adam.param_groups] == [0.0]
    assert [g["weight_decay"] for g in sgd.param_groups] == [WD]
    assert sgd.param_groups[0]["nesterov"] and sgd.param_groups[0]["momentum"] == 0.9
    assert len(sgd.param_groups[0]["params"]) == len(SHAPES) - 1  # not the frozen one


def test_multisteps_state_dict_round_trip():
    """A save between updates carries the accumulated gradients and both
    counts; a fresh optimizer loaded from it continues bit-equal."""
    cfg = cfg_dict("AdamW", "CosLR", 3)
    values, grads = draws()
    want, _, _ = port_run(cfg, values, grads)
    model = Params(values)
    opt, sched = builder.build_optimizer(ConfigDict(cfg), model, SPE)
    for step in range(4):  # one update and one micro-step of the next
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[step][n].copy())
        _update(opt, sched, step, CLIP)
    sd = opt.state_dict()
    assert (sd["mini_step"], sd["updates"], sd["every_k"]) == (1, 1, 3)
    assert any(a.abs().sum() > 0 for a in sd["acc"])
    fresh = Params({n: p.detach().numpy() for n, p in model.named_parameters()})
    opt2, sched2 = builder.build_optimizer(ConfigDict(cfg), fresh, SPE)
    opt2.load_state_dict(sd)
    for step in range(4, STEPS):
        for n, p in fresh.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[step][n].copy())
        _update(opt2, sched2, step, CLIP)
    for n, p in fresh.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[-1][n]), n
    with pytest.raises(ValueError, match="micro-steps"):
        builder.build_optimizer(ConfigDict(cfg_dict("AdamW", "CosLR", 2)), fresh,
                                SPE)[0].load_state_dict(sd)


def test_finetune_resume_mid_accumulation_is_bit_exact(tmp_path):
    """SGD with StepLR and step_per_update 2: 4 steps of epoch 0 against a
    run preempted after step 3 (one update taken, one micro-step in the
    mean) and resumed for step 4."""
    cfg = small_run_cfg(bs=8)
    cfg.optimizer = ConfigDict(dict(type="SGD", kwargs=dict(lr=0.01, weight_decay=1e-4)))
    cfg.scheduler = ConfigDict(dict(type="StepLR", kwargs=dict(step_size=1, gamma=0.7)))
    cfg.step_per_update = 2
    GUARD.reset()
    try:
        whole = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=4,
                                        experiment_path=str(tmp_path / "a"))
        GUARD.at_step = 3
        cut = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=4,
                                      experiment_path=str(tmp_path / "b"))
        assert cut.preempted and cut.steps == 3
        saved = torch.load(tmp_path / "b" / "ckpt-last.pth", weights_only=True)["optimizer"]
        assert (saved["mini_step"], saved["updates"]) == (1, 1)
        GUARD.reset()
        GUARD.at_step = None
        rest = runner_finetune.run_net(cfg, device="cpu", epochs=1, max_steps=1, resume=True,
                                       experiment_path=str(tmp_path / "b"))
    finally:
        GUARD.reset()
        GUARD.at_step = None
    assert rest.steps == whole.steps == 4 and not rest.preempted
    a, b = whole.state, rest.state
    for k, x in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], x), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["mini_step"], sa["updates"]) == (sb["mini_step"], sb["updates"]) == (0, 2)
    assert all(torch.equal(x, y) for x, y in zip(sa["acc"], sb["acc"], strict=True))
    for i, s in sa["inner"]["state"].items():
        assert torch.equal(sb["inner"]["state"][i]["momentum_buffer"], s["momentum_buffer"])


# ---------------------------------------------------------------------------
# --val_freq and the writer
# ---------------------------------------------------------------------------

class Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def close(self):
        pass


def validated_epochs(out: str, marker: str):
    """The epochs whose ``[Epoch e]`` line a validation line follows."""
    epochs, epoch = [], None
    for line in out.splitlines():
        if line.startswith("[Epoch "):
            epoch = int(line.split("]")[0].split()[1])
        elif marker in line:
            epochs.append(epoch)
    return epochs


def test_finetune_val_freq(tmp_path, capsys):
    """``epoch % val_freq == 0`` validates, as ``runner_finetune.py:265``:
    epochs 0 and 2 of 3 at val_freq 2; ckpt-last after every epoch."""
    runner_finetune.run_net(small_run_cfg(bs=8), device="cpu", epochs=3, max_steps=1,
                            val_freq=2, experiment_path=str(tmp_path))
    assert validated_epochs(capsys.readouterr().out, "[VALIDATION]") == [0, 2]
    assert torch.load(tmp_path / "ckpt-last.pth", weights_only=True)["epoch"] == 2


def test_pretrain_val_freq_and_writer(tmp_path, capsys):
    """The probe after epochs 0 and 3 of 4 at val_freq 3
    (``runner_pretrain.py:394-395``); the writer gets the step's loss and lr
    at batch 0 of each epoch, at the steps taken (``:373-375``)."""
    from act_tpu_torch.engine import runner_pretrain
    from tests.test_torch_port_stage2_run import pretrain_cfg
    from tests.test_torch_port_stage1_run import shapenet_node
    writer = Recorder()
    res = runner_pretrain.run_net(pretrain_cfg(shapenet_node("train")), device="cpu", epochs=4,
                                  max_steps=1, val_freq=3, allow_random_tokenizer=True,
                                  train_writer=writer, experiment_path=str(tmp_path))
    assert validated_epochs(capsys.readouterr().out, "[VALIDATION]") == [0, 3]
    assert len(res.probes) == 2
    _, schedule = builder.build_optimizer(ConfigDict(pretrain_cfg(shapenet_node("train"))),
                                          res.model, 512 // 4)
    want = []
    for step, loss in enumerate(res.epoch_loss, 1):  # one step an epoch: its mean is its loss
        want += [("Loss/Batch/Loss", loss, step), ("Loss/Batch/LR", schedule(step), step)]
    assert len(writer.scalars) == len(want) == 8
    for (tag, v, s), (wtag, wv, ws) in zip(writer.scalars, want):
        assert (tag, s) == (wtag, ws) and v == pytest.approx(wv, rel=1e-6)


def test_autoencoder_val_freq_and_writer(tmp_path, capsys):
    """Stage-I validation after epochs 0 and 2 of 3 at val_freq 2
    (``runner_autoencoder.py:270``); the writer gets the step's
    reconstruction loss x1000 at batch 0 of each epoch, at ``n_itr``
    (``:250-252``)."""
    from act_tpu_torch.engine import runner_autoencoder
    from tests.test_torch_port_stage1_run import run_cfg, write_tree
    writer = Recorder()
    res = runner_autoencoder.run_net(run_cfg(*write_tree(str(tmp_path / "tree"))), device="cpu",
                                     epochs=3, max_steps=1, val_freq=2, train_writer=writer,
                                     experiment_path=str(tmp_path / "exp"))
    assert validated_epochs(capsys.readouterr().out, "TEST RESULTS") == [0, 2]
    want = [("Loss/Batch/Recon", losses[0], n) for n, losses in enumerate(res.epoch_losses, 1)]
    assert [(t, s) for t, _, s in writer.scalars] == [(t, s) for t, _, s in want]
    for (_, v, _), (_, wv, _) in zip(writer.scalars, want):
        assert v == pytest.approx(wv, rel=1e-6)


def test_get_writer_on_rank_zero_only(tmp_path, monkeypatch):
    """Rank 0 gets a ``SummaryWriter`` where ``torch.utils.tensorboard``
    imports; another rank, or a machine without it, the null writer
    (``act_tpu/utils/writer.py:25-35``)."""
    import sys
    import types
    from act_tpu_torch.utils import writer as writer_mod
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = lambda path: ("summary", path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    assert writer_mod.get_writer(str(tmp_path / "w")) == ("summary", str(tmp_path / "w"))
    assert (tmp_path / "w").is_dir()
    monkeypatch.setattr(writer_mod, "process_index", lambda: 1)
    assert isinstance(writer_mod.get_writer(str(tmp_path / "v")), writer_mod.NullWriter)
    monkeypatch.setattr(writer_mod, "process_index", lambda: 0)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails
    null = writer_mod.get_writer(str(tmp_path / "u"))
    assert isinstance(null, writer_mod.NullWriter)
    null.add_scalar("x", 1.0, 0)
    null.close()


@pytest.mark.parametrize("flags,runner", [([], "runner_pretrain"),
                                          (["--finetune_model"], "runner_finetune")])
def test_main_passes_val_freq_and_the_writer(flags, runner, tmp_path, monkeypatch):
    """``--val_freq`` reaches the runner, the train writer the pretrain
    runner, and both writers are made under ``TFBoard/<exp_name>`` and
    closed."""
    import importlib
    from act_tpu_torch import main as port_main
    mod = importlib.import_module(f"act_tpu_torch.engine.{runner}")
    monkeypatch.chdir(tmp_path)
    seen, made = {}, []
    monkeypatch.setattr(mod, "run_net", lambda config, **kw: seen.update(kw))
    monkeypatch.setattr(port_main, "get_writer",
                        lambda path: made.append(path) or Recorder())
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "tiny.yaml").write_text("model: {NAME: PointTransformer}\n")
    port_main.main(["--config", "cfgs/tiny.yaml", "--device", "cpu", "--val_freq", "4", *flags])
    assert seen["val_freq"] == 4
    assert made == [f"./work_dirs/tiny/cfgs/TFBoard/default/{s}" for s in ("train", "test")]
    assert isinstance(seen.get("train_writer", Recorder()), Recorder)
    assert ("train_writer" in seen) == (runner == "runner_pretrain")
