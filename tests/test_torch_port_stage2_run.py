"""The port's Stage-II runner, its Stage-I hand-over, the SVM probe and the
chain to finetune held against the JAX package on the CPU.

The tokenizer loaded from a port Stage-I checkpoint holds its tensors, and
after the bf16 cast and the train steps still equals them in bf16, bit for
bit; from a reference-layout ``.pth`` it equals what ``act_tpu``'s
``load_dvae_ckpt`` loads, through the weight bridge, exactly. The probe
features equal the JAX ``feat_step``'s (FPS + gather resample, eval-mode
``forward_eval``) within 1e-5 (f32, sum order). The probe's solver is held
to sklearn's ``LinearSVC``, imported only here: the JAX ``evaluate_svm``
(sklearn's default, which stops at ``tol=1e-4``) gives the same accuracy and
predictions wherever its top-two decision margin exceeds 1e-3, and the
decision values are within 1e-3 of sklearn solved to ``tol=1e-8`` (the
default stops early enough on separable data to leave them further apart, at
a higher objective in every class). Two epochs and one epoch, a resume and
one more end in the same state, with the datasets' subsample draws fixed.
"""
import ast
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from act_tpu import ops as jops
from act_tpu.engine import runner_pretrain as jrunner
from act_tpu.models import ACT_PointDistillation as JDistill
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import main as port_main
from act_tpu_torch import ops
from act_tpu_torch.datasets import DataLoader, build_dataset_from_cfg, scale_and_translate
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_autoencoder, runner_finetune
from act_tpu_torch.engine import runner_pretrain as runner
from act_tpu_torch.utils.config import ConfigDict
from act_tpu_torch.utils.svm import LinearSVC

from tests.test_torch_port_finetune_data import small_run_cfg
from tests.test_torch_port_stage1 import smoke_cfg
from tests.test_torch_port_stage1_run import fixed_draws, shapenet_node, write_tree  # noqa: F401
from tests.test_torch_port_stage2 import RNGS, jax_variables

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

FEW_SHOT = {"NAME": "ModelNetFewShot", "DATA_PATH": "data/absent", "N_POINTS": 256,
            "way": 5, "shot": 10, "fold": 0}  # 50 train and 100 test clouds
PROBE_NPOINTS = 128  # the probe resamples the 256-point clouds by FPS
# the JAX package, its root tools (``bench.py``, ``__graft_entry__.py``, ``tools/``) and what
# only the JAX side or the tests may import
FORBIDDEN = {"jax", "flax", "orbax", "sklearn", "matplotlib", "act_tpu", "bench",
             "__graft_entry__", "tools"}


def probe_node(subset):
    return {"_base_": FEW_SHOT, "others": {"subset": subset, "npoints": PROBE_NPOINTS}}


def pretrain_cfg(train_node, dvae_ckpt=None, bs=4):
    """The tiny distillation model (``__graft_entry__._pretrain_cfg``, the
    Stage-I smoke widths) on ``train_node``, probed on the few-shot splits."""
    model = graft._pretrain_cfg(tiny=True)
    model.dvae_config.ckpt = dvae_ckpt
    return ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=1e-3, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        dataset=dict(train=train_node, val=probe_node("test"),
                     extra_train=probe_node("train")),
        total_bs=bs, max_epoch=300, model=dict(model)))


@pytest.fixture(scope="module")
def stage_one(tmp_path_factory):
    """A port Stage-I checkpoint of the smoke-width dVAE (teacher blocks in
    bf16) and its ``base_model``."""
    cfg = smoke_cfg()
    model = runner_autoencoder.prepare_model(cfg, 7, "cpu")
    optimizer, _ = builder.build_optimizer(cfg, model, 1)
    d = str(tmp_path_factory.mktemp("stage1"))
    path = ckpt_lib.save_checkpoint(model, optimizer, 0, 0, None, None, "ckpt-best", d)
    return path, torch.load(path, weights_only=True)["base_model"]


def tokenizer_params(model):
    return {k[len(runner.TOKENIZER) + 1:]: v for k, v in model.state_dict().items()
            if k.startswith(runner.TOKENIZER + ".") and "running" not in k
            and "num_batches" not in k}


# ---------------------------------------------------------------------------
# the Stage-I hand-over
# ---------------------------------------------------------------------------

def test_load_dvae_ckpt_from_a_stage_one_checkpoint(stage_one, capsys):
    path, source = stage_one
    cfg = pretrain_cfg(shapenet_node("train"), path)
    model = runner.build_pretrain_model(cfg.model, seed=1)
    n = runner.load_dvae_ckpt(model, cfg.model.dvae_config)
    tok = getattr(model, runner.TOKENIZER).state_dict()
    assert n == len(tok) and "decoder.mlp.0.weight" in source and not any(
        k.startswith("decoder.") for k in tok)
    for k, v in tok.items():
        assert v.dtype == torch.float32 or k.endswith("num_batches_tracked")
        assert torch.equal(v, source[k].to(v.dtype)), k
    assert "ignored" not in capsys.readouterr().out
    prepared = runner.prepare_model(cfg, 1, "cpu")
    for k, v in tokenizer_params(prepared).items():
        assert torch.equal(v, source[k].to(v.dtype)), k
    assert prepared.dvae_tokenizer.dgcnn_1.layer1[0].weight.dtype == torch.bfloat16


def test_load_dvae_ckpt_from_a_reference_pth_matches_jax(tmp_path, rng):
    """A reference-layout ``.pth`` (``base_model`` with DDP's ``module.``
    prefix, the decoder included): the port's tokenizer equals the JAX
    package's after its ``load_dvae_ckpt``, tensor for tensor."""
    cfg = pretrain_cfg(shapenet_node("train"))
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm = JDistill(JConfigDict(dict(cfg.model)))
    v = jax_variables(jm, rng, pts)
    src = runner_autoencoder.build_autoencoder_model(smoke_cfg().model, seed=3)
    path = str(tmp_path / "dvae.pth")
    torch.save({"base_model": {"module." + k: x for k, x in src.state_dict().items()}}, path)
    cfg.model.dvae_config.ckpt = path
    want = jrunner.load_dvae_ckpt(v, JConfigDict(dict(cfg.model.dvae_config)), runner.TOKENIZER)
    want = weights.distillation_state_dict(want["params"], want["batch_stats"])
    model = runner.build_pretrain_model(cfg.model, seed=1)
    runner.load_dvae_ckpt(model, cfg.model.dvae_config)
    got = model.state_dict()
    keys = [k for k in want if k.startswith(runner.TOKENIZER + ".")]
    assert set(keys) == {runner.TOKENIZER + "." + k for k in
                         getattr(model, runner.TOKENIZER).state_dict()}
    for k in keys:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], src.state_dict()[k[len(runner.TOKENIZER) + 1:]]), k


def test_load_dvae_ckpt_refuses_what_it_cannot_load(stage_one, tmp_path, capsys):
    path, source = stage_one
    cfg = pretrain_cfg(shapenet_node("train"), str(tmp_path / "absent.pth"))
    model = runner.build_pretrain_model(cfg.model, seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FileNotFoundError, match="allow_random_tokenizer"):
        runner.load_dvae_ckpt(model, cfg.model.dvae_config)
    assert runner.load_dvae_ckpt(model, cfg.model.dvae_config, allow_random=True) == 0
    cfg.model.dvae_config.ckpt = None
    assert runner.load_dvae_ckpt(model, cfg.model.dvae_config) == 0
    assert capsys.readouterr().out.count("RANDOMLY INITIALIZED") == 2
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    short = {k: v for k, v in source.items() if k != "codebook"}
    torch.save({"base_model": short}, tmp_path / "short.pth")
    cfg.model.dvae_config.ckpt = str(tmp_path / "short.pth")
    with pytest.raises(KeyError, match="codebook"):
        runner.load_dvae_ckpt(model, cfg.model.dvae_config)
    os.makedirs(tmp_path / "ckpt_act_dvae.orbax")
    cfg.model.dvae_config.ckpt = str(tmp_path / "ckpt_act_dvae.orbax")
    with pytest.raises(ValueError, match=r"\.pth"):
        runner.load_dvae_ckpt(model, cfg.model.dvae_config)
    with pytest.raises(ValueError, match=r"\.pth"):
        runner.run_net(pretrain_cfg(shapenet_node("train"), cfg.model.dvae_config.ckpt),
                       device="cpu", epochs=1)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def test_probe_features_match_jax_feat_step(rng):
    """FPS + gather to 128 of the 256-point clouds, then the eval-mode cls
    feature, at B=8: within 1e-5 of JAX's; the model's mode is restored."""
    cfg = pretrain_cfg(shapenet_node("train"))
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm = JDistill(JConfigDict(dict(cfg.model)))
    v = jax_variables(jm, rng, pts)
    model = runner.build_pretrain_model(cfg.model)
    model.load_state_dict(weights.distillation_state_dict(v["params"], v["batch_stats"]),
                          strict=True)
    model.train()
    ds = build_dataset_from_cfg(ConfigDict(probe_node("test")))
    feats, labels = runner.probe_features(model, DataLoader(ds, 8), PROBE_NPOINTS)
    assert model.training and feats.shape == (100, 32) and feats.dtype == np.float32

    @jax.jit
    def feat_step(variables, x):
        x = jops.gather_points(x, jops.furthest_point_sample(x, PROBE_NPOINTS))
        return jm.apply(variables, x, noaug=True, rngs=RNGS)
    want = np.concatenate([np.asarray(feat_step(v, jnp.asarray(np.stack(
        [ds[i][2][0] for i in range(b, min(b + 8, 100))])))) for b in range(0, 100, 8)])
    np.testing.assert_allclose(feats, want, rtol=0, atol=1e-5)
    assert np.array_equal(labels, [ds[i][2][1] for i in range(100)])
    assert np.abs(feats[1:] - feats[:-1]).max() > 1e-2  # neighbouring rows apart


def svm_data(kind, rng, n=300, d=24, k=5):
    spread = {"separable": 3.0, "overlapping": 0.4}[kind]
    centres = rng.normal(size=(k, d)) * spread
    labels = rng.integers(0, k, 2 * n)
    x = (centres[labels] + rng.normal(size=(2 * n, d))).astype(np.float32)
    return x[:n], labels[:n], x[n:], labels[n:]


@pytest.mark.parametrize("kind", ["separable", "overlapping"])
def test_evaluate_svm_matches_sklearn(kind, rng):
    svm = pytest.importorskip("sklearn.svm")
    xtr, ytr, xte, yte = svm_data(kind, rng)
    acc, clf = runner.evaluate_svm(xtr, ytr, xte, yte)
    assert clf.rel_grad_ <= 1e-6 and clf.n_iter_ <= 50
    want = jrunner.evaluate_svm(xtr, ytr, xte, yte)
    default = svm.LinearSVC().fit(xtr, ytr)
    dec = default.decision_function(xte)
    top2 = np.sort(dec, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    pred = clf.predict(xte)
    assert np.array_equal(pred[clear], default.predict(xte)[clear])
    if clear.all():
        assert acc == want
    assert abs(acc - want) <= (~clear).mean()
    tight = svm.LinearSVC(tol=1e-8, max_iter=100000).fit(xtr, ytr)
    np.testing.assert_allclose(clf.decision_function(xte).numpy(),
                               tight.decision_function(xte), rtol=0, atol=1e-3)
    if kind == "overlapping":  # where the default's early stop costs nothing
        np.testing.assert_allclose(clf.decision_function(xte).numpy(), dec, rtol=0, atol=1e-3)
    assert acc == float((pred == yte).mean()) and 0.0 < acc <= 1.0


def test_linear_svc_objective_labels_and_ties(rng):
    """The solution is the minimum (a step either way raises the objective);
    labels keep their values; a binary problem predicts as sklearn's single
    classifier; a tie of decision values goes to the first class."""
    xtr, ytr, xte, _ = svm_data("overlapping", rng, n=120, d=6, k=3)
    clf = LinearSVC().fit(xtr, ytr * 10 + 7)
    assert set(clf.predict(xte)) <= {7, 17, 27}
    X = clf._augment(xtr, None)
    Y = torch.where(torch.as_tensor(ytr)[None] == torch.arange(3)[:, None], 1.0, -1.0).double()
    W = torch.cat([clf.coef_, clf.intercept_[:, None]], 1)
    f = clf._objective(W, X, Y)
    for _ in range(5):
        d = torch.as_tensor(rng.normal(size=W.shape)) * 1e-3
        assert bool((clf._objective(W + d, X, Y) > f).all())
    two = (ytr == 0).astype(int)
    sk = pytest.importorskip("sklearn.svm").LinearSVC(tol=1e-8, max_iter=100000).fit(xtr, two)
    b = LinearSVC().fit(xtr, two)
    assert np.array_equal(b.predict(xte), sk.predict(xte))
    np.testing.assert_allclose(b.coef_[1].numpy(), sk.coef_[0], atol=1e-4)
    flat = LinearSVC().fit(np.zeros((4, 2)), [0, 1, 2, 0])
    flat.coef_.zero_()
    flat.intercept_.zero_()
    assert list(flat.predict(np.ones((2, 2)))) == [0, 0]


# ---------------------------------------------------------------------------
# run_net, resume, checkpoints, the chain and the CLI
# ---------------------------------------------------------------------------

def test_run_net_keeps_the_stage_one_tokenizer_and_checkpoints(stage_one, tmp_path):
    """Two steps on the Stage-I tokenizer: its parameters stay the Stage-I
    tensors in bf16, bit for bit, the student moves; the probe runs and
    ckpt-best and ckpt-last are written, in bf16 where the model is."""
    path, source = stage_one
    cfg = pretrain_cfg(shapenet_node("train"), path)
    res = runner.run_net(cfg, device="cpu", epochs=1, max_steps=2,
                         experiment_path=str(tmp_path))
    assert res.step == 2 and len(res.probes) == 1 and res.best_metrics.acc > 0
    assert res.probes[0].svm_rel_grad <= 1e-6
    for k, v in tokenizer_params(res.model).items():
        assert torch.equal(v, source[k].to(v.dtype)), k
    fresh = runner.build_pretrain_model(cfg.model, 0).state_dict()
    assert not torch.equal(res.model.state_dict()["proj_head.weight"], fresh["proj_head.weight"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt-best.pth", "ckpt-last.pth"]
    best = torch.load(tmp_path / "ckpt-best.pth", weights_only=True)
    assert best["metrics"] == {"acc": res.best_metrics.acc} and best["step"] == 2
    assert best["base_model"]["dvae_tokenizer.visual_embed.1.weight"].dtype == torch.float32
    assert best["base_model"]["dvae_tokenizer.codebook"].dtype == torch.bfloat16


def test_snapshot_epochs():
    assert [e for e in range(0, 400) if runner.is_snapshot_epoch(e)] == [250, 275, 300, 325,
                                                                       350, 375]


def test_run_net_resume_continues_exactly(stage_one, tmp_path, fixed_draws):  # noqa: F811
    """Two epochs, and one epoch + resume + one epoch, on 8 clouds at B=4:
    the same model, optimizer state, lr, step and best probe accuracy."""
    data, pc = write_tree(str(tmp_path / "tree"))
    cfg = pretrain_cfg(shapenet_node("train", data, pc), stage_one[0])
    whole = runner.run_net(cfg, device="cpu", epochs=2, experiment_path=str(tmp_path / "a"))
    runner.run_net(cfg, device="cpu", epochs=1, experiment_path=str(tmp_path / "b"))
    rest = runner.run_net(cfg, device="cpu", epochs=2, resume=True,
                          experiment_path=str(tmp_path / "b"))
    assert whole.step == rest.step == 4 and len(rest.epoch_loss) == 1
    assert rest.best_metrics.acc == whole.best_metrics.acc
    assert rest.probes[0].acc == whole.probes[1].acc
    for k, x in whole.model.state_dict().items():
        assert torch.equal(rest.model.state_dict()[k], x), k
    a, b = whole.optimizer.state_dict(), rest.optimizer.state_dict()
    assert [g["lr"] for g in a["param_groups"]] == [g["lr"] for g in b["param_groups"]]
    for i, s in a["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(b["state"][i][name], s[name]), (i, name)


def test_start_ckpts_and_the_modelnet_branch(stage_one, tmp_path):
    """``start_ckpts`` loads a checkpoint's weights (no epoch run here);
    the ModelNet train branch resamples by FPS + gather to ``npoints``
    before the augment, with JAX's FPS picks."""
    path, _ = stage_one
    cfg = pretrain_cfg(shapenet_node("train"), path)
    runner.run_net(cfg, device="cpu", epochs=1, max_steps=1, experiment_path=str(tmp_path))
    saved = torch.load(tmp_path / "ckpt-last.pth", weights_only=True)["base_model"]
    again = runner.run_net(cfg, device="cpu", epochs=0, seed=5,
                           start_ckpts=str(tmp_path / "ckpt-last.pth"),
                           experiment_path=str(tmp_path / "c"))
    for k, x in again.model.state_dict().items():
        assert torch.equal(x, saved[k]), k
    modelnet = build_dataset_from_cfg(ConfigDict({"_base_": dict(FEW_SHOT, NAME="ModelNet",
                                                                NUM_CATEGORY=40),
                                                  "others": {"subset": "train"}}))
    transform = runner.pretrain_transform(modelnet, 64)
    pts = torch.from_numpy(np.stack([modelnet[i][2][0] for i in range(3)]))
    got = transform(pts, torch.Generator().manual_seed(1))
    idx = np.asarray(jops.furthest_point_sample(jnp.asarray(pts.numpy()), 64))
    want = scale_and_translate(ops.gather_coords(pts, torch.from_numpy(idx).int()),
                               torch.Generator().manual_seed(1))
    assert got.shape == (3, 64, 3) and torch.equal(got, want)
    assert runner.pretrain_transform(build_dataset_from_cfg(ConfigDict(shapenet_node("train"))),
                                     64) is scale_and_translate


def test_chain_stage_one_to_stage_two_to_finetune(stage_one, tmp_path, capsys):
    """The pipeline on the CPU: the Stage-I checkpoint as the tokenizer, a
    Stage-II step and its checkpoint, then a finetune step from it through
    the student-prefix lift and the merge."""
    cfg = pretrain_cfg(shapenet_node("train"), stage_one[0])
    runner.run_net(cfg, device="cpu", epochs=1, max_steps=1, experiment_path=str(tmp_path))
    ft = small_run_cfg(transfer="full")
    ft.model.cls_dim = 40
    st = runner_finetune.build_state(ft, 1, device="cpu", ckpts=str(tmp_path / "ckpt-best.pth"))
    saved = torch.load(tmp_path / "ckpt-best.pth", weights_only=True)["base_model"]
    assert torch.equal(st.model.state_dict()["blocks.blocks.1.mlp.fc2.weight"],
                       saved["ACT_encoder.blocks.blocks.1.mlp.fc2.weight"])
    merged = int(capsys.readouterr().out.split("[CKPT] merged ")[1].split()[0])
    assert merged == sum(k.startswith("ACT_encoder.") and not k.startswith(
        "ACT_encoder.cls_head.") for k in saved)
    run = runner_finetune.run_finetune_steps(ft, 1, device="cpu", state=st)
    assert np.isfinite(run.losses).all()


def test_main_pretrains_and_dispatches_finetune(stage_one, tmp_path, monkeypatch, capsys):
    """``act_tpu_torch.main`` pretrains on the config (the dVAE from
    ``dvae_config.ckpt``) into ``work_dirs``; ``--finetune_model`` hands
    ``--ckpts`` or ``--start_ckpts`` to the finetune runner."""
    monkeypatch.chdir(tmp_path)
    cfg = pretrain_cfg(shapenet_node("train", *write_tree(str(tmp_path))), stage_one[0])
    cfg.max_epoch = 1
    (tmp_path / "cfgs").mkdir()
    yaml_path = tmp_path / "cfgs" / "tiny_pretrain.yaml"
    import yaml
    node = cfg.dataset.train
    yaml_path.write_text(yaml.safe_dump(
        {**{k: v for k, v in _plain(cfg).items() if k != "dataset"},
         "dataset": {"train": {"_base_": str(_write_base(tmp_path, node["_base_"])),
                               "others": _plain(node["others"])},
                     **{n: {"_base_": str(_write_base(tmp_path, FEW_SHOT)),
                            "others": _plain(cfg.dataset[n]["others"])}
                        for n in ("val", "extra_train")}}}))
    port_main.main(["--config", str(yaml_path), "--device", "cpu", "--num_workers", "0"])
    exp = tmp_path / "work_dirs" / "tiny_pretrain" / "cfgs" / "default"
    assert {"ckpt-best.pth", "ckpt-last.pth", "config.yaml"} <= set(os.listdir(exp))
    assert "linear-probe acc" in capsys.readouterr().out
    calls = []
    monkeypatch.setattr(runner_finetune, "run_net", lambda config, **kw: calls.append(kw))
    port_main.main(["--config", str(yaml_path), "--device", "cpu", "--finetune_model",
                    "--start_ckpts", "s.pth"])
    port_main.main(["--config", str(yaml_path), "--device", "cpu", "--scratch_model",
                    "--ckpts", "c.pth"])
    assert [c["ckpts"] for c in calls] == ["s.pth", None]
    assert calls[0]["experiment_path"].endswith(os.path.join("tiny_pretrain", "cfgs",
                                                             "default"))


def _plain(node):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def _write_base(tmp_path, base):
    import yaml
    path = tmp_path / f"base_{base['NAME']}.yaml"
    path.write_text(yaml.safe_dump(_plain(base)))
    return path


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = pretrain_cfg(shapenet_node("train"))
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_net(cfg, epochs=1, allow_random_tokenizer=True)


def test_the_port_imports_nothing_of_jax_sklearn_or_matplotlib():
    """No module of the package and nothing in ``chip_smoke.py`` imports JAX,
    flax, orbax, sklearn, matplotlib, the JAX package or its root tools."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "act_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(root, "chip_smoke.py")]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
