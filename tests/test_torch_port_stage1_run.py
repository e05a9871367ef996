"""The port's ShapeNet-55 data, loader, Stage-I runner and CLIs held against
the JAX package on the CPU.

ShapeNet items and batches, and the loader's batches in order, equal the JAX
classes' bit for bit (numpy on both sides), on the synthetic fallback and on
a small ``.npy`` tree written from a seed. The Stage-I ``validate`` table
runs the JAX smoke-width dVAE (``tests/test_torch_port_stage1.py``) with the
JAX variables carried over, the Gumbel draws pinned to a constant on both
sides, over a tree whose categories hold 3, 1 and 2 clouds: per category
and Overall (the mean of the category means) within 1e-5 relative (f32; the
JAX Chamfer takes the expanded-form distances above 4096 pairs). The teacher
load through a timm-layout ``.pth`` equals ``act_tpu``'s within 1e-6. A run
of two epochs and a run of one epoch, a resume and one more end in the same
state, bit for bit, with the datasets' subsample draws fixed (they are not
checkpointed, in JAX either).
"""
import os

import numpy as np
import pytest
import torch

from act_tpu.datasets import build as jdatasets_build
from act_tpu.datasets.io import IO as JIO
from act_tpu.datasets.loader import DataLoader as JDataLoader
from act_tpu.engine import runner_autoencoder as jrunner
from act_tpu.models import dvae as jdvae
from act_tpu.utils import meters as jmeters
from act_tpu.utils import parser as jparser
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import main as port_main
from act_tpu_torch import main_autoencoder
from act_tpu_torch.datasets import DataLoader, build_dataset_from_cfg
from act_tpu_torch.datasets import pointcloud_datasets as pcd
from act_tpu_torch.datasets.io import IO
from act_tpu_torch.engine import builder, weights
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_autoencoder as runner
from act_tpu_torch.engine import serve
from act_tpu_torch.utils import parser
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_stage1 import build, jax_model, smoke_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

N_FILE = 256  # points a file of the small trees
TREE = {"test": {"02691156": 3, "02828884": 1, "04379243": 2},
        "train": {"02691156": 2, "03001627": 4, "04379243": 2}}


def write_tree(root, splits=TREE, n_points=N_FILE, seed=0):
    """A ShapeNet-55 layout under ``root``: ``ShapeNet-55/{split}.txt`` and
    ``shapenet_pc/{taxonomy}-{model}.npy`` clouds of ``n_points`` points
    drawn from ``seed``. Returns (DATA_PATH, PC_PATH)."""
    rng = np.random.default_rng(seed)
    data, pc = os.path.join(root, "ShapeNet-55"), os.path.join(root, "shapenet_pc")
    os.makedirs(data, exist_ok=True)
    os.makedirs(pc, exist_ok=True)
    for split, counts in splits.items():
        lines = []
        for tax, n in counts.items():
            for i in range(n):
                name = f"{tax}-{split}{i:03d}.npy"
                np.save(os.path.join(pc, name), rng.normal(size=(n_points, 3)).astype(np.float32))
                lines.append(name)
        order = rng.permutation(len(lines))
        with open(os.path.join(data, f"{split}.txt"), "w") as f:
            f.write("".join(lines[i] + "\n" for i in order))
    return data, pc


def shapenet_node(subset, data="data/absent", pc="data/absent", npoints=128, whole=False,
                  n_points=N_FILE):
    return {"_base_": {"NAME": "ShapeNet", "N_POINTS": n_points, "DATA_PATH": data,
                       "PC_PATH": pc},
            "others": {"subset": subset, "npoints": npoints, "whole": whole}}


def both(node):
    """The JAX and the port dataset of ``node``."""
    return (jdatasets_build.build_dataset_from_cfg(JConfigDict(node)),
            build_dataset_from_cfg(ConfigDict(node)))


@pytest.fixture
def tree(tmp_path):
    return write_tree(str(tmp_path))


# ---------------------------------------------------------------------------
# files, datasets and the loader
# ---------------------------------------------------------------------------

def test_io_matches_jax(tmp_path, rng):
    """``.npy`` (C order through the memoised header, Fortran order through
    ``np.load``), ``.txt`` and ``.h5`` read as the JAX ``IO`` reads them."""
    x = rng.normal(size=(64, 3)).astype(np.float32)
    paths = {"c.npy": lambda p: np.save(p, x), "f.npy": lambda p: np.save(p, np.asfortranarray(x)),
             "x.txt": lambda p: np.savetxt(p, x, delimiter=",")}
    for name, write in paths.items():
        write(str(tmp_path / name))
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "x.h5", "w") as f:
        f["data"] = x
    for name in [*paths, "x.h5"]:
        got, want = IO.get(str(tmp_path / name)), JIO.get(str(tmp_path / name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    with pytest.raises(ValueError):
        IO.get(str(tmp_path / "x.ply"))


@pytest.mark.parametrize("data", ["synthetic", "npy", "npy whole"])
def test_shapenet_items_and_batches_match_jax(data, tree):
    """The same file list and taxonomies; items, then ``get_batch`` over
    shuffled index chunks, bit for bit (the subsample draws of both come
    from ``default_rng(0)`` in the same order)."""
    node = (shapenet_node("test", n_points=512) if data == "synthetic" else
            shapenet_node("train", *tree, whole=data == "npy whole"))
    jds, tds = both(node)
    assert len(tds) == len(jds) == (512 if data == "synthetic" else
                                    sum(TREE["train"].values())
                                    + (sum(TREE["test"].values()) if "whole" in data else 0))
    assert tds.file_list == jds.file_list
    for i in (0, 3, 1, len(tds) - 1):
        got, want = tds[i], jds[i]
        assert got[:2] == want[:2] and got[2].dtype == np.float32
        assert np.array_equal(got[2], want[2]), i
    order = np.random.default_rng(5).permutation(len(tds))
    for chunk in (order[:4], order[4:7], order[7:8]):
        (gt, gm, gp), (wt, wm, wp) = tds.get_batch(chunk), jds.get_batch(chunk)
        assert (list(gt), list(gm)) == (list(wt), list(wm))
        assert gp.dtype == np.float32 and np.array_equal(gp, wp)


def test_shapenet_batch_equals_its_items(tree):
    """``get_batch`` gives what collating the items gives, with the same draws."""
    node = shapenet_node("train", *tree)
    a, b = build_dataset_from_cfg(ConfigDict(node)), build_dataset_from_cfg(ConfigDict(node))
    chunk = np.array([4, 0, 7, 2])
    tax, mid, pts = a.get_batch(chunk)
    items = [b[int(i)] for i in chunk]
    assert list(tax) == [t for t, _, _ in items] and list(mid) == [m for _, m, _ in items]
    np.testing.assert_allclose(pts, np.stack([p for _, _, p in items]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_matches_jax_at_every_start_batch(prefetch, tree):
    """Batch for batch the JAX loader's, in order, for each ``start_batch``
    of two epochs, shuffled and unshuffled, with and without the prefetch
    thread."""
    for subset, shuffle in (("train", True), ("test", False)):
        jds, tds = both(shapenet_node(subset, *tree))
        jl = JDataLoader(jds, 3, shuffle=shuffle, drop_last=shuffle, seed=3, prefetch=prefetch)
        tl = DataLoader(tds, 3, shuffle=shuffle, drop_last=shuffle, seed=3, prefetch=prefetch)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            for start in range(len(tl) + 1):
                jl.set_epoch(epoch, start)
                tl.set_epoch(epoch, start)
                got, want = list(tl), list(jl)
                assert len(got) == len(want) == len(tl) - start
                for (gt, gm, gp), (wt, wm, wp) in zip(got, want):
                    assert list(gt) == list(wt) and list(gm) == list(wm)
                    assert np.array_equal(gp, wp)


def test_prefetch_thread_stops_with_its_consumer(tree):
    _, tds = both(shapenet_node("train", *tree))
    import threading
    before = threading.active_count()
    for _ in range(3):
        it = iter(DataLoader(tds, 2, prefetch=2))
        next(it)
        it.close()
    assert threading.active_count() == before


def test_worker_pool_returns_the_same_clouds(tree):
    """Two forked workers: the same batches in order, each cloud the same
    points as in one process (each worker draws its own permutation, so
    files of ``npoints`` points compare as point sets, to the rounding of
    the normalisation), and the workers' draws differ."""
    node = shapenet_node("train", *tree, npoints=N_FILE)
    tds = build_dataset_from_cfg(ConfigDict(node))
    one = list(DataLoader(build_dataset_from_cfg(ConfigDict(node)), 2, shuffle=True, seed=1))
    pool = DataLoader(tds, 2, shuffle=True, seed=1, num_workers=2)
    try:
        got = list(pool)
    finally:
        pool.close()
    assert pool._pool is None and len(got) == len(one)
    same_order = 0
    for (gt, gm, gp), (wt, wm, wp) in zip(got, one):
        assert list(gt) == list(wt) and list(gm) == list(wm)
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-6)
            same_order += int(np.array_equal(a, b))
    assert same_order < sum(len(p) for _, _, p in one)


def test_dataset_builder_workers_only_for_real_data(tree):
    """Workers for real data; synthetic batches, and real ones without
    workers, are built in process between steps (no prefetch thread)."""
    real = {**shapenet_node("train", *tree), "others": {"subset": "train", "npoints": 128,
                                                        "bs": 2}}
    synth = {**shapenet_node("train"), "others": {"subset": "train", "npoints": 128, "bs": 2}}
    real_loader = builder.dataset_builder(ConfigDict(real), 0, 8)[1]
    assert (real_loader.num_workers, real_loader.prefetch) == (8, 2)
    real_loader = builder.dataset_builder(ConfigDict(real), 0, 0)[1]
    assert (real_loader.num_workers, real_loader.prefetch) == (0, 0)
    _, loader = builder.dataset_builder(ConfigDict(synth), 0, 8)
    assert (loader.num_workers, loader.prefetch) == (0, 0) and loader.shuffle and loader.drop_last


@pytest.mark.parametrize("flags", [["--finetune_model", "--ckpts", "b.pth"], ["--test"]])
def test_main_passes_workers_and_logger_to_finetune(flags, tmp_path, monkeypatch):
    """``act_tpu_torch.main`` hands ``--num_workers`` and the run's logger to
    the finetune runner, whose loaders then fork that many workers for real
    data."""
    from act_tpu_torch.engine import runner_finetune
    cfg = runner_finetune.finetune_config(
        "cfgs/finetune_classification/full/finetune_modelnet.yaml")
    monkeypatch.chdir(tmp_path)
    seen = {}
    monkeypatch.setattr(runner_finetune, "run_net" if "--test" not in flags else "test_net",
                        lambda config, **kw: seen.update(kw))
    yaml = write_yaml(tmp_path / "finetune_tiny.yaml", "model: {NAME: PointTransformer}\n")
    port_main.main(["--config", yaml, "--device", "cpu", "--num_workers", "3", *flags])
    assert seen["num_workers"] == 3 and seen["logger"].name == "finetune_tiny"
    made = []
    monkeypatch.setattr(builder, "dataset_builder",
                        lambda node, seed, workers: made.append(workers) or (None, None))
    runner_finetune.loaders(cfg, 0, ("train", "val"), 3)
    assert made == [3, 3]


def test_run_net_closes_its_loaders(tree, monkeypatch):
    """Stage-I ``run_net`` closes the val loader as well as the train loader,
    so no worker pool outlives the run."""
    closed = []
    monkeypatch.setattr(DataLoader, "close", lambda self: closed.append(self.batch_size))
    runner.run_net(run_cfg(*tree), epochs=1, max_steps=1, max_val=1, device="cpu",
                   experiment_path=str(tree[0]) + "_exp")
    assert sorted(closed) == [1, 4]


# ---------------------------------------------------------------------------
# the teacher load and the validation table
# ---------------------------------------------------------------------------

def timm_state_dict(dim, depth, rng):
    """A timm ViT's state dict: blocks, final norm and the parts the teacher
    has no place for."""
    sd = {"cls_token": rng.normal(size=(1, 1, dim)), "pos_embed": rng.normal(size=(1, 5, dim)),
          "patch_embed.proj.weight": rng.normal(size=(dim, 3, 16, 16)),
          "norm.weight": rng.normal(size=(dim,)), "norm.bias": rng.normal(size=(dim,)),
          "head.weight": rng.normal(size=(10, dim))}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": rng.normal(size=(dim,)),
                   p + "norm1.bias": rng.normal(size=(dim,)),
                   p + "attn.qkv.weight": rng.normal(size=(3 * dim, dim)),
                   p + "attn.qkv.bias": rng.normal(size=(3 * dim,)),
                   p + "attn.proj.weight": rng.normal(size=(dim, dim)),
                   p + "attn.proj.bias": rng.normal(size=(dim,)),
                   p + "norm2.weight": rng.normal(size=(dim,)),
                   p + "norm2.bias": rng.normal(size=(dim,)),
                   p + "mlp.fc1.weight": rng.normal(size=(4 * dim, dim)),
                   p + "mlp.fc1.bias": rng.normal(size=(4 * dim,)),
                   p + "mlp.fc2.weight": rng.normal(size=(dim, 4 * dim)),
                   p + "mlp.fc2.bias": rng.normal(size=(dim,))})
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def test_load_teacher_weights_matches_jax(tmp_path, rng):
    cfg = smoke_cfg()
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm, v = jax_model(cfg, rng, pts)
    path = str(tmp_path / "vit.pth")
    torch.save({"model": timm_state_dict(48, 2, rng)}, path)
    cfg.model.teacher_ckpt = path
    want = jrunner.load_teacher_weights(v, JConfigDict(dict(cfg.model)))
    want_sd = weights.dvae_state_dict(want["params"], want["batch_stats"])
    model = build(cfg, v)
    assert runner.load_teacher_weights(model, cfg.model) == 2 * 12 + 2
    got = model.state_dict()
    moved = 0
    for k, x in want_sd.items():
        np.testing.assert_allclose(got[k].numpy(), x.numpy(), rtol=0, atol=1e-6, err_msg=k)
        moved += int(k.startswith("visual_embed.") and not torch.equal(
            x, weights.dvae_state_dict(v["params"], v["batch_stats"])[k]))
    assert moved == 2 * 12 + 2


def test_load_teacher_weights_without_the_file_keeps_the_teacher(capsys):
    cfg = smoke_cfg()
    cfg.model.teacher_ckpt = "model_zoo/absent.pth"
    model = runner.build_autoencoder_model(cfg.model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert runner.load_teacher_weights(model, cfg.model) == 0
    assert "RANDOMLY INITIALIZED" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


class RecordingMeter(jmeters.AverageMeter):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        RecordingMeter.made.append(self)


def test_validate_table_matches_jax_with_unequal_categories(tmp_path, rng, monkeypatch):
    """Categories of 3, 1 and 2 clouds: per category and Overall within 1e-5
    relative of the JAX table; the Overall row is the mean of the category
    means, which differs from the mean over clouds here."""
    cfg = smoke_cfg()
    G, V = cfg.model.num_group, cfg.model.num_tokens
    data, pc = write_tree(str(tmp_path), {"test": TREE["test"]})
    node = shapenet_node("test", data, pc)
    jds, tds = both(node)
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    jm, v = jax_model(cfg, rng, pts)
    model = build(cfg, v)
    import jax.numpy as jnp
    monkeypatch.setattr(jdvae, "fast_uniform",
                        lambda key, shape, minval, maxval: jnp.full(shape, 0.5, jnp.float32))
    monkeypatch.setattr(jrunner, "_RECON_STEP_CACHE", {})
    monkeypatch.setattr(jrunner, "AverageMeter", RecordingMeter)
    monkeypatch.setattr(serve, "recon_uniforms",
                        lambda model, batch, device: torch.full((batch, G, V), 0.5))
    RecordingMeter.made = []

    class State:
        def variables(self):
            return v
    jconfig = JConfigDict(dict(cfg))
    want = jrunner.validate(jm, State(), JDataLoader(jds, 1, prefetch=0), 0, None, jconfig)
    got, per_cloud = runner.validate(model, DataLoader(tds, 1))
    order = list(dict.fromkeys(t for t, _, _ in (tds[i] for i in range(len(tds)))))
    assert list(got.table) == sorted(order) and len(RecordingMeter.made) == len(order) + 1
    for tax, meter in zip(order, RecordingMeter.made):
        n, means = got.table[tax]
        assert n == meter.count(0) == TREE["test"][tax]
        np.testing.assert_allclose(means, meter.avg(), rtol=1e-5)
    overall = [got.state_dict()[k] for k in ("F-Score", "CDL1", "CDL2")]
    np.testing.assert_allclose(overall, [want.state_dict()[k] for k in ("F-Score", "CDL1",
                                                                         "CDL2")], rtol=1e-5)
    by_cloud = np.mean(per_cloud, axis=0)
    assert abs(by_cloud[1] - overall[1]) > 1e-3 * overall[1]  # the repair shows here


def test_validate_of_bare_clouds_is_one_category(rng):
    cfg = smoke_cfg()
    model = runner.build_autoencoder_model(cfg.model)
    clouds = [rng.normal(size=(128, 3)).astype(np.float32) for _ in range(3)]
    metrics, per_cloud = runner.validate(model, clouds)
    assert list(metrics.table) == ["-"] and metrics.table["-"][0] == 3
    np.testing.assert_allclose(metrics.table["-"][1], np.mean(per_cloud, axis=0), rtol=1e-12)


# ---------------------------------------------------------------------------
# run_net, resume, test_net and the CLIs
# ---------------------------------------------------------------------------

class FirstPoints:
    """A dataset ``rng`` whose subsample is the first ``num`` points."""

    def choice(self, n, num, replace=False):
        return np.arange(num)


@pytest.fixture
def fixed_draws(monkeypatch):
    init = pcd.ShapeNet.__init__

    def fixed(self, config):
        init(self, config)
        self.rng = FirstPoints()
    monkeypatch.setattr(pcd.ShapeNet, "__init__", fixed)


def run_cfg(data, pc, anneal=10):
    """``smoke_cfg`` on the tree: 8 train clouds at B=4 (2 steps an epoch),
    the test split for val and test; the temperature anneals over
    ``anneal`` iterations."""
    cfg = smoke_cfg(clip=10.0)
    cfg.total_bs = 4
    cfg.temp.ntime = anneal
    cfg.dataset = {"train": shapenet_node("train", data, pc),
                   "val": shapenet_node("test", data, pc),
                   "test": shapenet_node("test", data, pc)}
    return ConfigDict(dict(cfg))


def test_run_net_resume_continues_exactly(tmp_path, tree, fixed_draws):
    """Two epochs, and one epoch + resume + one epoch: the same model,
    optimizer state, lr, anneal iteration, temperatures, KLD weights and best
    metrics."""
    cfg = run_cfg(*tree)
    whole = runner.run_net(cfg, device="cpu", epochs=2, experiment_path=str(tmp_path / "a"))
    first = runner.run_net(cfg, device="cpu", epochs=1, experiment_path=str(tmp_path / "b"))
    rest = runner.run_net(cfg, device="cpu", epochs=2, resume=True,
                          experiment_path=str(tmp_path / "b"))
    assert (whole.step, whole.n_itr) == (rest.step, rest.n_itr) == (4, 4)
    assert first.temps + rest.temps == whole.temps and len(set(whole.temps)) == 4
    assert first.kld_weights + rest.kld_weights == whole.kld_weights
    assert rest.best_metrics.state_dict() == whole.best_metrics.state_dict()
    for k, x in whole.model.state_dict().items():
        assert torch.equal(rest.model.state_dict()[k], x), k
    a, b = whole.optimizer.state_dict(), rest.optimizer.state_dict()
    assert [g["lr"] for g in a["param_groups"]] == [g["lr"] for g in b["param_groups"]]
    for i, s in a["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(b["state"][i][name], s[name]), (i, name)
    last = torch.load(tmp_path / "b" / "ckpt-last.pth", weights_only=True)
    assert (last["epoch"], last["step"]) == (1, 4)
    assert last["base_model"]["visual_embed.0.0.mlp.fc1.weight"].dtype == torch.bfloat16


def test_run_net_saves_best_on_cdl1(tmp_path, tree, monkeypatch):
    """ckpt-best only when CDL1 is lower, ckpt-last every epoch."""
    saves, cdl1 = [], iter([5.0, 7.0, 3.0])
    save = ckpt_lib.save_checkpoint
    validate = runner.validate

    def recording_save(*args):
        saves.append((args[6], args[3]))  # (prefix, epoch)
        return save(*args)

    def scripted_validate(*args, **kw):
        metrics, per_cloud = validate(*args, **kw)
        metrics._values[1] = next(cdl1)
        return metrics, per_cloud
    monkeypatch.setattr(ckpt_lib, "save_checkpoint", recording_save)
    monkeypatch.setattr(runner, "validate", scripted_validate)
    res = runner.run_net(run_cfg(*tree), device="cpu", epochs=3, max_steps=1, max_val=1,
                         experiment_path=str(tmp_path))
    assert saves == [("ckpt-best", 0), ("ckpt-last", 0), ("ckpt-last", 1), ("ckpt-best", 2),
                     ("ckpt-last", 2)]
    assert res.best_metrics.state_dict()["CDL1"] == 3.0 and res.step == 3


def test_test_net_and_validate_net_from_a_checkpoint(tmp_path, tree):
    cfg = run_cfg(*tree)
    res = runner.run_net(cfg, device="cpu", epochs=1, max_steps=1,
                         experiment_path=str(tmp_path))
    best = str(tmp_path / "ckpt-best.pth")
    want = runner.validate(res.model, runner._loaders(cfg, 0, 0, ("test",))[0])[0]
    got = runner.test_net(cfg, ckpts=best, device="cpu", experiment_path=str(tmp_path),
                          max_dumps=2)
    assert got.state_dict() == want.state_dict()
    assert runner.validate_net(cfg, ckpts=best, device="cpu").state_dict() == want.state_dict()
    files = sorted(os.listdir(tmp_path / "vis"))
    assert len(files) == 4 and all(f.endswith(("_gt.txt", "_dense.txt")) for f in files)
    dense = np.loadtxt(tmp_path / "vis" / files[0])
    gt = np.loadtxt(tmp_path / "vis" / files[1])
    G, M = cfg.model.num_group, cfg.model.group_size
    assert dense.shape == (G * M, 3) and gt.shape == (128, 3)
    tax = next(iter(runner._loaders(cfg, 0, 0, ("test",))[0]))[0]
    assert files[0].startswith(f"{tax[0]}_000")  # the first cloud of the test split
    assert abs(np.linalg.norm(gt, axis=1).max() - 1.0) < 1e-5  # normalised, at %.6f
    assert np.abs(gt.mean(0)).max() < 1e-5


CLI_FLAGS = [[], ["--test", "--exp_name", "x"], ["--val", "--seed", "3"],
             ["--resume", "--num_workers", "2"], ["--start_ckpts", "a.pth", "--vote"],
             ["--finetune_model", "--ckpts", "b.pth", "--way", "5", "--shot", "10",
              "--fold", "2"], ["--scratch_model", "--allow_random_tokenizer"]]


@pytest.mark.parametrize("flags", CLI_FLAGS)
def test_cli_flags_and_experiment_dir_match_jax(flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "cfgs/pretrain/pretrain_act_distill.yaml", *flags]
    want = jparser.get_args(list(argv))
    got = parser.get_args(argv + ["--device", "cpu"])
    assert got.experiment_path == want.experiment_path and os.path.isdir(got.experiment_path)
    assert got.log_name == want.log_name and got.device == "cpu"
    for key, val in vars(got).items():
        if key != "device":
            assert getattr(want, key) == val, key
    with pytest.raises(ValueError):
        parser.get_args(["--config", "x.yaml", "--test", "--resume"])


def write_yaml(path, text):
    path.write_text(text)
    return str(path)


def test_main_autoencoder_trains_resumes_and_tests_on_cpu(tmp_path, monkeypatch, capsys):
    """The Stage-I CLI on a small config and tree: train one epoch, resume
    for a second (the config read back from the experiment directory), then
    ``--val`` and ``--test`` of ckpt-best."""
    data, pc = write_tree(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    base = write_yaml(tmp_path / "shapenet.yaml",
                      f"NAME: ShapeNet\nN_POINTS: 256\nDATA_PATH: {data}\nPC_PATH: {pc}\n")

    def node(subset):
        return "{_base_: " + base + ", others: {subset: " + subset + ", npoints: 128}}"
    yaml = write_yaml(tmp_path / "tiny_dvae.yaml", (
        "optimizer: {type: AdamW, kwargs: {lr: 0.0005, weight_decay: 0.0005}}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 300, initial_epochs: 10}}\n"
        "dataset:\n"
        f"  train: {node('train')}\n"
        f"  val: {node('test')}\n"
        f"  test: {node('test')}\n"
        "temp: {start: 1, target: 0.0625, ntime: 100000}\n"
        "kldweight: {start: 0, target: 0.1, ntime: 100000}\n"
        "model: {NAME: ACTPromptedDiscreteVAEwithVIT, visual_embed_type: vit_base_patch16_384,"
        " visual_embed_dim: 48, visual_embed_depth: 2, visual_embed_heads: 4,"
        " visual_embed_pos: after_dgcnn1, freeze_visual_embed: true, num_prompt_token: 4,"
        " use_deep_prompt: true, num_group: 16, group_size: 8, num_tokens: 64,"
        " encoder_dims: 32, tokens_dims: 32, decoder_dims: 32}\n"
        "npoints: 128\ntotal_bs: 4\nmax_epoch: 1\ngrad_norm_clip: 10\nconsider_metric: CDL1\n"))
    base = ["--config", yaml, "--device", "cpu", "--exp_name", "run", "--num_workers", "0"]
    main_autoencoder.main(base)
    exp = tmp_path / "work_dirs" / "tiny_dvae" / tmp_path.name / "run"
    assert sorted(p for p in os.listdir(exp) if p.endswith(".pth")) == ["ckpt-best.pth",
                                                                       "ckpt-last.pth"]
    text = (exp / "config.yaml").read_text().replace("max_epoch: 1", "max_epoch: 2")
    (exp / "config.yaml").write_text(text)
    main_autoencoder.main(base + ["--resume"])
    assert torch.load(exp / "ckpt-last.pth", weights_only=True)["epoch"] == 1
    main_autoencoder.main(base + ["--val", "--ckpts", str(exp / "ckpt-best.pth")])
    main_autoencoder.main(base + ["--test", "--ckpts", str(exp / "ckpt-best.pth")])
    out = capsys.readouterr().out
    assert "[RESUME] resumed at epoch 1" in out and out.count("Overall") == 4
    logs = [p for p in os.listdir(exp) if p.endswith(".log")]
    assert logs and "Overall" in "".join((exp / p).read_text() for p in logs)
    assert len(os.listdir(exp.parent / "test_run" / "vis")) == 2 * sum(TREE["test"].values())


def test_entry_points_default_to_the_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = run_cfg(*tree)
    for call in (lambda: runner.run_net(cfg, epochs=1),
                 lambda: runner.validate_net(cfg),
                 lambda: runner.test_net(cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
