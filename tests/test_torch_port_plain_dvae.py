"""Point-BERT's plain ``DiscreteVAE`` (``cfgs/autoencoder/pointbert_dvae.yaml``)
served and trained through the Stage-I CLI, held against the JAX package on
the CPU.

The serving tests of ``tests/test_torch_port_tokenize.py`` (``tokenize``
against ``forward_tokenizer`` over ``group_points``, ``dvae`` against
``apply(pts, 1.0, True)`` with JAX's sown draws replayed, the npoints checks,
both kinds over HTTP) run again here on the plain dVAE at the JAX smoke
widths (32 wide, 64 tokens, G=16, M=8, 128 points, f32), its JAX variables
drawn in numpy and carried over by the weight bridge. Then
``act_tpu_torch.main_autoencoder`` on a small ShapeNet-55 tree with the
YAML at those widths: one epoch, a resume for a second, ``--val`` and
``--test`` of ckpt-best, whose table equals the JAX runner's ``validate`` of
the same weights (moved back to flax by ``torch_convert``) within 1e-5
relative, the Gumbel draws pinned to 0.5 on both sides.
"""
import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu.datasets.loader import DataLoader as JDataLoader
from act_tpu.engine import runner_autoencoder as jrunner
from act_tpu.engine import torch_convert as tc
from act_tpu.models import dvae as jdvae
from act_tpu.models.dvae import DiscreteVAE as JPlain
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import main_autoencoder
from act_tpu_torch.engine import runner_autoencoder as runner
from act_tpu_torch.engine import serve

from tests import test_torch_port_tokenize as tk
from tests.test_torch_port_stage1 import (PLAIN_CFG, build, jax_model, jcfg, min_choice_gap,
                                          smoke_cfg, to_flax)
from tests.test_torch_port_stage2 import t
from tests.test_torch_port_stage1_run import TREE, both, shapenet_node, write_tree, write_yaml
from tests.test_torch_port_teachers import drawn_variables
from tests.test_torch_port_train import flat_np

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

N_PTS = tk.N_PTS


@pytest.fixture(scope="module")
def dvae():
    """(cfg, JAX module, perturbed variables, the port's model, (3, 128, 3)
    clouds) of the plain dVAE: the fixture the serving tests below take."""
    rng = np.random.default_rng(22)
    cfg = smoke_cfg(PLAIN_CFG)
    cfg.npoints = N_PTS
    pts = rng.normal(size=(3, N_PTS, 3)).astype(np.float32)
    jm = JPlain(jcfg(cfg).model)
    v = drawn_variables(jm, rng, pts)
    model = build(cfg, v)
    assert not model.has_teacher and not hasattr(model, "visual_embed")
    return cfg, jm, v, model, pts


test_tokenize_matches_jax = tk.test_tokenize_matches_jax
test_recon_matches_jax = tk.test_recon_matches_jax
test_dvae_serving_needs_npoints = tk.test_dvae_serving_needs_npoints
test_serve_http_dvae_kinds = tk.test_serve_http_dvae_kinds


def test_main_autoencoder_trains_resumes_and_tests_like_jax(tmp_path, monkeypatch, capsys):
    """The CLI on the plain dVAE: train one epoch (2 steps), resume for a
    second (the config read back from the experiment directory), ``--val``
    and ``--test`` of ckpt-best; the test table against the JAX runner's."""
    cfg = smoke_cfg(PLAIN_CFG)
    data, pc = write_tree(str(tmp_path))
    shipped = open(PLAIN_CFG).read()
    monkeypatch.chdir(tmp_path)
    base = write_yaml(tmp_path / "shapenet.yaml",
                      f"NAME: ShapeNet\nN_POINTS: 256\nDATA_PATH: {data}\nPC_PATH: {pc}\n")
    model_node = shipped[shipped.index("\nmodel:") + 1:shipped.index("\nnpoints:") + 1]
    assert "NAME: DiscreteVAE" in model_node and "visual_embed" not in model_node
    for key, val in (("encoder_dims", 32), ("tokens_dims", 32), ("decoder_dims", 32),
                     ("num_tokens", 64), ("num_group", 16), ("group_size", 8)):
        model_node = "\n".join(f"  {key}: {val}" if line.strip().startswith(f"{key}:") else line
                               for line in model_node.splitlines()) + "\n"
    model_node = model_node.replace("  dtype: bf16\n", "  dtype: f32\n")

    def node(subset):
        return "{_base_: " + base + ", others: {subset: " + subset + ", npoints: 128}}"
    yaml = write_yaml(tmp_path / "tiny_plain_dvae.yaml", (
        "optimizer: {type: AdamW, kwargs: {lr: 0.0005, weight_decay: 0.0005}}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 300, initial_epochs: 10}}\n"
        "dataset:\n"
        f"  train: {node('train')}\n"
        f"  val: {node('test')}\n"
        f"  test: {node('test')}\n"
        "temp: {start: 1, target: 0.0625, ntime: 100000}\n"
        "kldweight: {start: 0, target: 0.1, ntime: 100000}\n"
        + model_node
        + "npoints: 128\ntotal_bs: 4\nmax_epoch: 1\ngrad_norm_clip: 10\nconsider_metric: CDL1\n"))
    argv = ["--config", yaml, "--device", "cpu", "--exp_name", "run", "--num_workers", "0"]
    main_autoencoder.main(argv)
    exp = tmp_path / "work_dirs" / "tiny_plain_dvae" / tmp_path.name / "run"
    assert sorted(p for p in os.listdir(exp) if p.endswith(".pth")) == ["ckpt-best.pth",
                                                                       "ckpt-last.pth"]
    last = torch.load(exp / "ckpt-last.pth", weights_only=True)
    assert (last["epoch"], last["step"]) == (0, 2)
    assert not any(k.startswith("visual_embed") for k in last["base_model"])
    text = (exp / "config.yaml").read_text().replace("max_epoch: 1", "max_epoch: 2")
    (exp / "config.yaml").write_text(text)
    main_autoencoder.main(argv + ["--resume"])
    last = torch.load(exp / "ckpt-last.pth", weights_only=True)
    assert (last["epoch"], last["step"]) == (1, 4)
    best = str(exp / "ckpt-best.pth")
    main_autoencoder.main(argv + ["--val", "--ckpts", best])

    # --test with the Gumbel draws pinned, its table against the JAX runner's
    tests = []
    test_net = runner.test_net
    monkeypatch.setattr(runner, "test_net", lambda *a, **k: tests.append(test_net(*a, **k)))
    G, V = cfg.model.num_group, cfg.model.num_tokens
    monkeypatch.setattr(serve, "recon_uniforms",
                        lambda model, batch, device: torch.full((batch, G, V), 0.5))
    main_autoencoder.main(argv + ["--test", "--ckpts", best])
    out = capsys.readouterr().out
    assert "[RESUME] resumed at epoch 1" in out and out.count("Overall") == 4
    n_test = sum(TREE["test"].values())
    assert len(os.listdir(exp.parent / "test_run" / "vis")) == 2 * n_test

    monkeypatch.setattr(jdvae, "fast_uniform",
                        lambda key, shape, minval, maxval: jnp.full(shape, 0.5, jnp.float32))
    monkeypatch.setattr(jrunner, "_RECON_STEP_CACHE", {})
    sd = torch.load(best, weights_only=True)["base_model"]
    params, stats = tc.convert_state_dict({k: np.asarray(x) for k, x in sd.items()},
                                          tc.dvae_rules())
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})

    class State:
        def variables(self):
            return variables
    jds, _ = both(shapenet_node("test", data, pc))
    jm = JPlain(jcfg(cfg).model)
    want = jrunner.validate(jm, State(), JDataLoader(jds, 1, prefetch=0), 0, None,
                            JConfigDict(dict(cfg)))
    (got,) = tests
    names = ("F-Score", "CDL1", "CDL2")
    np.testing.assert_allclose([got.state_dict()[k] for k in names],
                               [want.state_dict()[k] for k in names], rtol=1e-5)
    assert got.state_dict()["CDL1"] > 0



# clouds, weights and draws on which no max-pool or Chamfer choice of the plain
# dVAE's loss is near a tie (checked in the test)
STEP_SEED = 7


def test_loss_and_gradients_match_jax(monkeypatch):
    """The plain dVAE's loss and every parameter's gradient against JAX's
    ``value_and_grad`` of ``apply`` + ``get_loss`` (the JAX runner's step
    loss), f32, temperature 0.5, KLD weight 0.05, on 2 clouds of 8 groups,
    the Gumbel uniforms drawn in numpy (behind an ``optimization_barrier``
    on the JAX side, else XLA folds their logs at compile time): gradients
    within 1e-4 of each tensor's largest. The BatchNorms take their running
    statistics here; ``test_train_mode_step_matches_jax_in_f64`` holds the
    batch-statistics step."""
    rng = np.random.default_rng(STEP_SEED)
    cfg = smoke_cfg(PLAIN_CFG)
    cfg.model.num_group = 8
    temp, kldw = 0.5, 0.05
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    u = rng.uniform(1e-10, 1.0, size=(2, 8, 64)).astype(np.float32)
    monkeypatch.setattr(jdvae, "fast_uniform", lambda key, shape, minval, maxval:
                        jax.lax.optimization_barrier(jnp.asarray(u)))
    jm, v = jax_model(cfg, rng, pts)

    def loss_fn(p):
        variables = {"params": p, "batch_stats": v["batch_stats"]}
        ret = jm.apply(variables, jnp.asarray(pts), temp, False,
                       rngs={"gumbel": jax.random.PRNGKey(0)})
        recon, kld = jm.apply(variables, ret, pts, method=jm.get_loss)
        return recon + jnp.float32(kldw) * kld, (recon, kld)
    (j_loss, (j_recon, j_kld)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    model = build(cfg, v).eval()
    monkeypatch.setattr(model, "forward", functools.partial(model.forward, gumbel_u=t(u)))
    assert min_choice_gap(model, t(pts), temp, kldw, monkeypatch) > 5e-7
    recon, kld = model.get_loss(model(t(pts), temp, False))
    (recon + kldw * kld).backward()
    np.testing.assert_allclose([float(recon + kldw * kld), float(recon), float(kld)],
                               [float(j_loss), float(j_recon), float(j_kld)], rtol=0, atol=1e-5)
    got_g, _ = to_flax({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    want_g = flat_np(j_grads)
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in got_g.items():
        if np.abs(want_g[k]).max() >= 1e-6 * g_max:  # else zero up to rounding
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-4 * np.abs(want_g[k]).max(), err_msg=k)


def test_train_mode_step_matches_jax_in_f64(monkeypatch):
    """One training-mode step of the plain dVAE (batch statistics) against
    JAX's ``apply(..., train=True, mutable=["batch_stats"])`` + ``get_loss``,
    both sides in f64 (``jax.enable_x64()``, the port's model ``.double()``),
    on the draws of the eval-mode test above (the clouds kept in f64).

    In f32 the two differ by up to 7e-3 of a tensor's largest gradient: the
    E[x^2] - E[x]^2 batch variance, which both packages compute, cancels a
    mean far above the spread of some BatchNorm inputs, so each framework's
    rounding of the two sums comes out at 1e-3. That is the whole gap: with
    only the BatchNorm statistics taken in f64 on both sides, every other
    value in f32, it falls to 8e-6, the eval-mode test's level; in f64 to
    1.2e-9. Held here: the loss within 1e-9, every gradient within 1e-8 of
    its tensor's largest, the updated running statistics within 1e-10 of
    theirs."""
    rng = np.random.default_rng(STEP_SEED)
    cfg = smoke_cfg(PLAIN_CFG)
    cfg.model.num_group = 8
    temp, kldw = 0.5, 0.05
    pts = rng.normal(size=(2, 128, 3))
    u = rng.uniform(1e-10, 1.0, size=(2, 8, 64)).astype(np.float32).astype(np.float64)
    jm, v = jax_model(cfg, rng, pts.astype(np.float32))
    with jax.enable_x64(True):
        monkeypatch.setattr(jdvae, "fast_uniform", lambda key, shape, minval, maxval:
                            jax.lax.optimization_barrier(jnp.asarray(u)))
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), v)

        def loss_fn(p):
            variables = {"params": p, "batch_stats": v64["batch_stats"]}
            ret, new = jm.apply(variables, jnp.asarray(pts), temp, False, train=True,
                                rngs={"gumbel": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
            recon, kld = jm.apply(variables, ret, jnp.asarray(pts), method=jm.get_loss)
            return recon + kldw * kld, new["batch_stats"]
        (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        assert j_loss.dtype == jnp.float64

    model = build(cfg, v).double().train()
    monkeypatch.setattr(model, "forward", functools.partial(model.forward,
                                                            gumbel_u=torch.from_numpy(u)))
    x = torch.from_numpy(pts)
    assert min_choice_gap(model, x, temp, kldw, monkeypatch) > 1e-7
    recon, kld = model.get_loss(model(x, temp, False))
    loss = recon + kldw * kld
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-9)
    got_g, _ = to_flax({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    want_g = flat_np(j_grads)
    assert sorted(got_g) == sorted(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in got_g.items():
        if np.abs(want_g[k]).max() >= 1e-6 * g_max:  # else zero up to rounding
            np.testing.assert_allclose(g, want_g[k], rtol=0,
                                       atol=1e-8 * np.abs(want_g[k]).max(), err_msg=k)
    _, got_s = to_flax({n: b for n, b in model.named_buffers() if "running" in n})
    want_s = flat_np(j_stats)
    assert sorted(got_s) == sorted(want_s) and len(want_s) == 8
    for k, s in got_s.items():
        np.testing.assert_allclose(s, want_s[k], rtol=0,
                                   atol=1e-10 * np.abs(want_s[k]).max(), err_msg=k)
        assert not np.array_equal(s, flat_np(v["batch_stats"])[k]), k  # moved
