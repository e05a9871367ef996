"""``act_tpu_torch.parity_protocol`` and ``act_tpu_torch.part_segmentation_vis``
held against ``tools/parity_protocol.py`` and ``part_segmentation/main_vis.py``
on the CPU.

Narrow configs are written to ``tmp_path`` and patched into the task tables
of both tools; the synthetic datasets serve 16 clouds; the released-layout
``.pth`` files are fabricated from a seed. The JAX tool converts each file
with its own converter; the port reads it as it is.

- The eval legs against the JAX tool on the same ``.pth``: the test OA
  over the same 16 ScanObjectNN clouds, and the best of 2 vote rounds with
  the port's draws pinned to JAX's keys (``VoteDraws``), each equal or at
  most one cloud apart (an FPS pick or an argmax at a near tie may go the
  other way between the two packages' f32 roundings); the S3DIS whole-scene
  vote mIoU on a written one-room tree, 3 rounds: equal; the dVAE's
  CDL1/CDL2/F-score table of 4 validation clouds, the Gumbel uniforms pinned
  to 0.5 on both sides: within 1e-5 relative (the Stage-I validation test's
  tolerance).
- The training legs by their orchestration: each few-shot fold's way, shot
  and fold reach ``finetune_config`` and ``run_net``, its best OA is read
  from its ckpt-best, a fold without one is skipped, the mean and std are
  ``np.mean`` / ``np.std``; one fold of a real few-shot finetune and a real
  ``--from_pretrain`` run end to end at a narrow width.
- The dumps equal ``main_vis.py``'s on the same weights (JAX variables, the
  port's through ``weights.seg_state_dict``) and shapes.
- A released file missing a key raises and names it; the CLI's last line is
  the JSON dict; ``device`` defaults to the card and raises without one.
"""
import json
import os
import sys
from functools import partial

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from act_tpu.datasets import pointcloud_datasets as jpcd
from act_tpu.engine import runner_autoencoder as jrun_ae
from act_tpu.engine import runner_finetune as jrun_ft
from act_tpu.models import dvae as jdvae
from tools import parity_protocol as jtool

import __graft_entry__ as graft
from act_tpu_torch import parity_protocol as tool
from act_tpu_torch import part_segmentation_vis
from act_tpu_torch.datasets import pointcloud_datasets as pcd
from act_tpu_torch.engine import runner_finetune, runner_segmentation, serve, weights
from act_tpu_torch.engine.runner_autoencoder import build_autoencoder_model
from act_tpu_torch.models import MODELS
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_dist_seg import SEG_G, WIDTHS, jax_seg_model
from tests.test_torch_port_finetune_data import VoteDraws
from tests.test_torch_port_seg_run import write_partnormal
from tests.test_torch_port_stage1 import VIT_CFG, smoke_cfg
from tests.test_torch_port_teachers import drawn_variables
from tests.test_torch_port_tp import plain

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

CLOUDS, BS, NPOINTS = 16, 4, 128  # test batches of 2 * BS = 8 clouds
ONE_CLOUD = 100.0 / CLOUDS
MODEL = dict(NAME="PointTransformer", embed_dim=32, depth=2, drop_path_rate=0.0, num_heads=2,
             group_size=8, num_group=16, encoder_dims=32, transfer_type="full")
CDL_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_data(monkeypatch, tmp_path):
    """16-cloud synthetic datasets in both packages, run in ``tmp_path``."""
    monkeypatch.setattr(jpcd._SyntheticMixin, "synthetic_len", CLOUDS)
    monkeypatch.setattr(pcd._SyntheticMixin, "synthetic_len", CLOUDS)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def write_cfg(path, cfg) -> str:
    """``cfg`` as a YAML at ``path``, each ``_base_`` node in a file of its own
    beside it (the configs' loaders read ``_base_`` as a path)."""
    bases = []

    def files(x):
        if not isinstance(x, dict):
            return x
        out = {k: files(v) for k, v in x.items()}
        if isinstance(out.get("_base_"), dict):
            base = f"{path}.base{len(bases)}.yaml"
            bases.append(base)
            with open(base, "w") as f:
                yaml.safe_dump(out["_base_"], f)
            out["_base_"] = base
        return out
    with open(path, "w") as f:
        yaml.safe_dump(files(plain(dict(cfg))), f)
    return str(path)


def finetune_yaml(tmp, name, dataset, cls_dim, **node):
    nodes = {s: dict(_base_=dict(NAME=dataset, **node), others=dict(subset=sub))
             for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))}
    cfg = dict(optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
               scheduler=dict(type="CosLR", kwargs=dict(epochs=2, initial_epochs=1)),
               dataset=nodes, model=dict(MODEL, cls_dim=cls_dim), npoints=NPOINTS,
               total_bs=BS, max_epoch=1, grad_norm_clip=10)
    return write_cfg(tmp / f"{name}.yaml", cfg)


def released_classifier(path, cls_dim, seed=0):
    """A fabricated finetuned classifier in the reference layout, the group
    encoder's conv biases (which the JAX converter folds) not zero."""
    model = MODELS.build(ConfigDict(dict(MODEL, cls_dim=cls_dim)))
    model.init_weights(torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k in ("encoder.first_conv.0.bias", "encoder.second_conv.0.bias"):
        sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
    torch.save({"base_model": sd, "epoch": 299}, path)
    return sd


@pytest.fixture
def scan(small_data, monkeypatch):
    tmp = small_data
    cfg = finetune_yaml(tmp, "scan", "ScanObjectNN_hardest", 15, ROOT=str(tmp / "absent"))
    for t in (tool, jtool):
        monkeypatch.setitem(t.TASKS, "scan_hardest", (cfg, 88.21))
    pth = str(tmp / "released_scan.pth")
    released_classifier(pth, 15)
    return tmp, pth


def test_test_and_vote_match_the_jax_tool(scan, monkeypatch):
    tmp, pth = scan
    test_vote_rounds = jrun_ft.test_vote_rounds
    monkeypatch.setattr(jrun_ft, "test_vote_rounds",
                        lambda *a, **kw: test_vote_rounds(*a, **{**kw, "rounds": 2}))
    want = jtool.run_protocol("scan_hardest", pth, vote=False, exp_name="j")
    got = tool.run_protocol("scan_hardest", pth, vote=False, device="cpu", exp_name="p")
    assert abs(got["ours"] - want["ours"]) <= ONE_CLOUD, (got["ours"], want["ours"])
    assert (got["zoo_acc"], got["vote"], got["from_pretrain"]) == (88.21, False, False)
    assert set(got) == set(want)

    want = jtool.run_protocol("scan_hardest", pth, vote=True, exp_name="jv")
    draws = VoteDraws(monkeypatch, 2 * BS, NPOINTS)
    root = jax.random.PRNGKey(0)  # the JAX runner's set_random_seed(0)
    for r in range(2):
        for i in range(CLOUDS // (2 * BS)):
            draws.load(jax.random.fold_in(jax.random.fold_in(root, r), i), 10)
    got = tool.run_protocol("scan_hardest", pth, vote=True, vote_rounds=2, device="cpu",
                            exp_name="pv")
    assert not draws.queue  # every JAX draw replayed
    assert got["vote"] and abs(got["ours"] - want["ours"]) <= ONE_CLOUD, (got, want)


def test_whole_scene_miou_matches_the_jax_tool(small_data, monkeypatch):
    tmp = small_data
    rng = np.random.default_rng(1)
    root = tmp / "s3dis" / "stanford_indoor3d"
    os.makedirs(root)
    room = rng.random((3000, 7)).astype(np.float32)
    room[:, :2] *= 1.2
    room[:, 6] = rng.integers(0, 13, size=3000)
    np.save(root / "Area_5_office_1.npy", room)
    model = serve.load_seg_model("semseg", None, 128, "f32", 3, "cpu", widths=WIDTHS)
    pth = str(tmp / "s3dis_best.pth")
    torch.save({"model_state_dict": model.state_dict(), "epoch": 99}, pth)
    jax_seg_model("semseg", monkeypatch)  # the JAX tool's model, narrowed the same way
    monkeypatch.setattr(runner_segmentation, "load_seg_model",
                        partial(serve.load_seg_model, widths=WIDTHS))
    want = jtool.run_protocol("s3dis", pth, data_root=str(tmp / "s3dis"), exp_name="j")
    got = tool.run_protocol("s3dis", pth, data_root=str(tmp / "s3dis"), device="cpu")
    assert got["ours"] == pytest.approx(want["ours"], abs=1e-9)
    assert set(got) == set(want) and got["zoo_acc"] == 61.2


def test_dvae_table_matches_the_jax_tool(small_data, monkeypatch):
    tmp = small_data
    monkeypatch.chdir(REPO)  # the YAML's _base_ paths are the repo's
    cfg = smoke_cfg(VIT_CFG)
    monkeypatch.chdir(tmp)
    for split in ("train", "val", "test"):
        base = cfg.dataset[split]._base_
        base.DATA_PATH = base.PC_PATH = str(tmp / "absent")
    path = write_cfg(tmp / "dvae.yaml", cfg)
    for t in (tool, jtool):
        monkeypatch.setitem(t.DVAE_TASKS, "dvae", path)
    model = build_autoencoder_model(cfg.model, 4)
    pth = str(tmp / "released_dvae.pth")
    torch.save({"base_model": model.state_dict()}, pth)
    G, V = int(cfg.model.num_group), int(cfg.model.num_tokens)
    monkeypatch.setattr(jdvae, "fast_uniform",
                        lambda key, shape, minval, maxval: jax.numpy.full(shape, 0.5))
    monkeypatch.setattr(jrun_ae, "_RECON_STEP_CACHE", {})
    monkeypatch.setattr(serve, "recon_uniforms",
                        lambda model, batch, device: torch.full((batch, G, V), 0.5))
    want = jtool.run_protocol("dvae", pth, exp_name="j", smoke=True)  # 4 validation clouds
    got = tool.run_protocol("dvae", pth, device="cpu", max_batches=4)
    assert got["zoo_acc"] is None and set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=CDL_RTOL), k
    with pytest.raises(SystemExit, match="teacher_arch"):
        tool.run_protocol("dvae", pth, device="cpu", teacher_arch="bert")


# ---------------------------------------------------------------------------
# the training legs
# ---------------------------------------------------------------------------

def pretrain_pth(path, seed=0):
    """A fabricated Stage-II pretrain file (``ACT_encoder.`` keys) whose
    student is ``MODEL``'s backbone."""
    m = plain(dict(graft._pretrain_cfg(tiny=True)))
    model = MODELS.build(ConfigDict(m))
    model.init_weights(torch.Generator().manual_seed(seed))
    torch.save({"base_model": model.state_dict()}, path)
    return model.state_dict()


def test_fewshot_folds_orchestration(small_data, monkeypatch):
    tmp = small_data
    cfg = finetune_yaml(tmp, "fs", "ModelNetFewShot", -1, DATA_PATH=str(tmp / "absent"),
                        N_POINTS=256)
    monkeypatch.setattr(tool, "FEWSHOT_CFG", cfg)
    pth = str(tmp / "pretrain.pth")
    pretrain_pth(pth)
    seen, runs = [], []
    finetune_config = runner_finetune.finetune_config
    monkeypatch.setattr(runner_finetune, "finetune_config",
                        lambda c, way=-1, shot=-1, fold=-1: seen.append((way, shot, fold))
                        or finetune_config(c, way, shot, fold))
    best = {0: 60.0, 2: 75.0, 3: 90.0}

    def fake_run_net(config, **kw):
        runs.append((kw["way"], kw["shot"], kw["fold"], kw["experiment_path"]))
        cfg = finetune_config(config, kw["way"], kw["shot"], kw["fold"])
        assert cfg.dataset.train.others.way == kw["way"] and cfg.model.cls_dim == kw["way"]
        assert set(kw["ckpts"]) >= {"encoder.first_conv.0.weight", "blocks.blocks.0.attn.qkv.weight"}
        if kw["fold"] in best:
            os.makedirs(kw["experiment_path"], exist_ok=True)
            torch.save({"best_metrics": {"acc": best[kw["fold"]]}},
                       os.path.join(kw["experiment_path"], "ckpt-best.pth"))
    monkeypatch.setattr(runner_finetune, "run_net", fake_run_net)
    got = tool.run_protocol("fewshot_modelnet_10w20s", pth, device="cpu", folds=[0, 1, 2, 3],
                            exp_name="fs")
    assert seen == [(10, 20, f) for f in range(4)]
    assert [r[:3] for r in runs] == [(10, 20, f) for f in range(4)]
    assert runs[1][3].endswith("fs_f1")
    accs = list(best.values())
    assert got["ours"] == float(np.mean(accs)) and got["std"] == float(np.std(accs))
    assert (got["zoo_acc"], got["folds"], got["from_pretrain"]) == (95.6, 3, True)


def test_pretrain_legs_run_end_to_end(small_data, monkeypatch):
    """One fold of a few-shot finetune and ``modelnet --from_pretrain`` for
    one epoch of 2 steps each, then the test of its ckpt-best, at the narrow
    width; a pretrain file without a backbone key raises."""
    tmp = small_data
    fs = finetune_yaml(tmp, "fs", "ModelNetFewShot", -1, DATA_PATH=str(tmp / "absent"),
                       N_POINTS=256)
    mn = finetune_yaml(tmp, "mn", "ModelNet", 2, DATA_PATH=str(tmp / "absent"), N_POINTS=256,
                       NUM_CATEGORY=2)  # two classes: a seeded run beats OA 0 and writes ckpt-best
    monkeypatch.setattr(tool, "FEWSHOT_CFG", fs)
    monkeypatch.setitem(tool.TASKS, "modelnet", (mn, 93.70))
    pth = str(tmp / "pretrain.pth")
    sd = pretrain_pth(pth)
    got = tool.run_protocol("fewshot_modelnet_5w10s", pth, device="cpu", folds=[0], epochs=1,
                            max_steps=2)
    assert 0.0 <= got["ours"] <= 100.0 and got["std"] == 0.0 and got["folds"] == 1
    assert os.path.exists("work_dirs/parity/parity_fewshot_modelnet_5w10s_f0/ckpt-best.pth")
    got = tool.run_protocol("modelnet", pth, from_pretrain=True, vote=True, vote_rounds=2,
                            device="cpu", epochs=1, max_steps=2, max_batches=1)
    assert 0.0 <= got["ours"] <= 100.0 and got["from_pretrain"] and got["vote"]
    del sd["ACT_encoder.blocks.blocks.1.mlp.fc2.weight"]
    torch.save({"base_model": sd}, pth)
    with pytest.raises(KeyError, match="blocks.blocks.1.mlp.fc2.weight"):
        tool.run_protocol("modelnet", pth, from_pretrain=True, device="cpu", epochs=1)


# ---------------------------------------------------------------------------
# the dumps, the loads, the CLI
# ---------------------------------------------------------------------------

def test_dumps_equal_main_vis(small_data, monkeypatch):
    tmp = small_data
    write_partnormal(tmp / "pn")
    jm = jax_seg_model("partseg", monkeypatch)
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(1, NPOINTS, 3)).astype(np.float32)
    oh = np.eye(16, dtype=np.float32)[[2]]
    v = drawn_variables(jm, rng, pts, oh)
    ocp.PyTreeCheckpointer().save(str(tmp / "jax_ckpt"), v, force=True)
    torch.save({"base_model": weights.seg_state_dict(v["params"], v["batch_stats"], True)},
               tmp / "port.pth")
    monkeypatch.setattr(part_segmentation_vis, "load_seg_model",
                        partial(serve.load_seg_model, widths=WIDTHS))
    from part_segmentation import main_vis
    common = ["--npoint", str(NPOINTS), "--num_group", str(SEG_G), "--root", str(tmp / "pn"),
              "--num_shapes", "2"]
    monkeypatch.setattr(sys, "argv", ["main_vis.py", *common, "--ckpts", str(tmp / "jax_ckpt"),
                                      "--out", str(tmp / "jax_vis")])
    main_vis.main()
    files = part_segmentation_vis.main([*common, "--ckpts", str(tmp / "port.pth"),
                                        "--out", str(tmp / "port_vis"), "--device", "cpu"])
    want = sorted(f for f in os.listdir(tmp / "jax_vis") if f.endswith(".txt"))
    assert [os.path.basename(f) for f in files] == want and len(want) == 2
    for name in want:
        a = np.loadtxt(tmp / "port_vis" / name)
        assert a.shape == (NPOINTS, 5)
        np.testing.assert_array_equal(a, np.loadtxt(tmp / "jax_vis" / name))


def test_missing_key_raises_and_cli_prints_json_last(scan, capsys):
    tmp, pth = scan
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tool.run_protocol("scan_hardest", pth)
    result = tool.main(["--task", "scan_hardest", "--ckpt", pth, "--device", "cpu",
                        "--max_batches", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == result and result["task"] == "scan_hardest"
    sd = torch.load(pth, weights_only=True)["base_model"]
    del sd["cls_head_finetune.8.weight"]
    torch.save({"base_model": sd}, pth)
    with pytest.raises(RuntimeError, match="cls_head_finetune.8.weight"):
        tool.run_protocol("scan_hardest", pth, device="cpu", max_batches=1)
