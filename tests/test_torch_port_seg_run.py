"""The port's segmentation datasets, metrics, runners, whole-scene vote and CLIs
held against the JAX package on the CPU.

Tolerances: the datasets' items, the loader's batches and the host augment
are numpy on both sides and compared exactly; the metrics on fixed logits
within 1e-12 (the same float64 sums); the whole-scene votes of batched
blocks against one block a forward within 1e-5 (eval mode makes a block's
log-probs independent of its batch, up to the CPU's f32 product blocking),
and the same metrics; the port's whole-scene vote against JAX's on the same
f32 weights: the vote pools (a point's probabilities summed over the ~4 blocks
that hold it) within 1e-4
(measured 1.8e-5), the same vote wherever JAX's top two are more than 1e-4
apart (all but 8 of 16384 points; every point's vote was equal), the same
metrics. The runners and CLIs run 1-2 steps at 128 points a
cloud on synthetic data under ``tmp_path``.
"""
import json
import os
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from act_tpu.datasets import segmentation_datasets as jds
from act_tpu.datasets.loader import DataLoader as JDataLoader
from act_tpu.engine import runner_segmentation as jrun
from act_tpu.engine.torch_convert import convert_state_dict, seg_rules
from act_tpu.models.segmentation import SemSegTransformer as JSemSeg
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import part_segmentation, semantic_segmentation, semantic_segmentation_test
from act_tpu_torch.datasets import segmentation_datasets as tds
from act_tpu_torch.datasets.loader import DataLoader
from act_tpu_torch.engine import runner_segmentation as trun
from act_tpu_torch.engine.serve import build_infer_fn, load_seg_model

from tests.test_torch_port_seg import jax_variables, model_cfg, port_model

NPOINT, G = 128, 16


def write_partnormal(root):
    """Tiny files in the released ShapeNetPart layout
    (``tests/test_segmentation.py:113-137``), two categories."""
    rng = np.random.default_rng(0)
    os.makedirs(root / "train_test_split")
    cats = {"Airplane": ("02691156", 4), "Mug": ("03797390", 2)}
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{c}\t{s}\n" for c, (s, _) in cats.items()))
    splits = {"train": [], "val": [], "test": []}
    for c, (synset, parts) in cats.items():
        os.makedirs(root / synset)
        for k in range(4):
            pts = rng.normal(size=(200, 7)).astype(np.float32)
            pts[:, 6] = tds.SEG_CLASSES[c][0] + rng.integers(0, parts, size=200)
            np.savetxt(root / synset / f"model{k}.txt", pts)
            splits[("train", "train", "val", "test")[k]].append(f"shape_data/{synset}/model{k}")
    for name, ids in splits.items():
        (root / "train_test_split" / f"shuffled_{name}_file_list.json").write_text(json.dumps(ids))


def write_s3dis(root):
    """Room files (N x 7: xyzrgb + label) in Area_* naming
    (``tests/test_segmentation.py:139-165``)."""
    rng = np.random.default_rng(1)
    os.makedirs(root)
    for name in ("Area_1_office.npy", "Area_2_hall.npy", "Area_5_office.npy"):
        room = rng.random((20000, 7)).astype(np.float32)
        room[:, :2] *= 1.5
        room[:, 6] = rng.integers(0, 13, size=20000)
        np.save(root / name, room)


def datasets(kind, root, pkg):
    if kind == "partnormal":
        return [pkg.PartNormalDataset(str(root), NPOINT, split=s, normal_channel=n)
                for s, n in (("trainval", False), ("train", True), ("val", False),
                             ("test", False))]
    if kind == "s3dis":
        return [pkg.S3DISDataset(s, str(root), NPOINT, test_area=5) for s in ("train", "test")]
    return [pkg.WholeSceneDataset(str(root), NPOINT, test_area=5)]


def items(ds):
    """Every item the dataset gives for a fixed index sequence (indices
    repeat, so the draws of its rng are compared too); a whole-scene dataset's
    blocks of every scene, twice."""
    if hasattr(ds, "blocks_for_scene"):
        return [b for _ in range(2) for s in range(len(ds)) for b in ds.blocks_for_scene(s)]
    n = len(ds)
    return [ds[i % n] for i in (0, 1, 0, n - 1, 3, 1)]


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("kind", ["partnormal", "s3dis", "wholescene"])
def test_datasets_match_jax(tmp_path, kind, real):
    root = tmp_path / "data"
    if real:
        (write_partnormal if kind == "partnormal" else write_s3dis)(root)
    for jd, td in zip(datasets(kind, root, jds), datasets(kind, root, tds)):
        assert td.synthetic == jd.synthetic == (not real) and len(td) == len(jd) > 0
        for name in ("labelweights", "room_idxs", "datapath", "classes"):
            if hasattr(jd, name):
                assert_same(getattr(td, name), getattr(jd, name))
        got, want = items(td), items(jd)
        assert len(got) == len(want) > 0
        assert_same(got, want)


def test_loader_batches_and_augment_match_jax():
    """The train loader's shuffled batches and the host scale-and-shift."""
    jl = JDataLoader(jds.PartNormalDataset("/nope", NPOINT, "trainval"), 4, shuffle=True,
                     drop_last=True, seed=0, prefetch=0)
    tl = DataLoader(tds.PartNormalDataset("/nope", NPOINT, "trainval"), 4, shuffle=True,
                    drop_last=True, seed=0, prefetch=0)
    for loader in (jl, tl):
        loader.set_epoch(1)
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    for _, jb, tb in zip(range(3), jl, tl):
        assert_same(tb, jb)
        assert_same(trun._np_augment(tr, tb[0]), jrun._np_augment(jr, jb[0]))


def fixed_logits(rng, shape):
    return np.log(rng.dirichlet(np.ones(shape[-1]), size=shape[:-1])).astype(np.float32)


@pytest.mark.parametrize("task", ["partseg", "semseg"])
def test_metrics_on_fixed_logits_match_jax(task):
    """part_iou_per_shape on every category, then evaluate_partseg /
    evaluate_semseg over three batches of fixed logits (one batch's
    predictions copied from its labels, so the IoUs are not all small)."""
    rng = np.random.default_rng(2)
    if task == "partseg":
        for cat, parts in tds.SEG_CLASSES.items():
            pred, gt = rng.choice(parts + [49], 40), rng.choice(parts, 40)
            assert trun.part_iou_per_shape(pred, gt, cat) == jrun.part_iou_per_shape(pred, gt, cat)
        batches = [(np.zeros((4, 30, 3), np.float32), rng.integers(0, 16, 4),
                    rng.integers(0, 50, (4, 30))) for _ in range(3)]
        logits = [fixed_logits(rng, (4, 30, 50)) for _ in batches]
    else:
        batches = [(np.zeros((4, 30, 3), np.float32), rng.integers(0, 13, (4, 30)))
                   for _ in range(3)]
        logits = [fixed_logits(rng, (4, 30, 13)) for _ in batches]
    hot = np.full_like(logits[0], -10.0)
    np.put_along_axis(hot, batches[0][-1][..., None], 0.0, -1)
    logits[0] = hot
    calls = iter(logits * 2)
    if task == "partseg":
        want = jrun.evaluate_partseg(lambda v, p, o: next(calls), None, batches)
        got = trun.evaluate_partseg(lambda p, o: torch.from_numpy(next(calls)), batches)
    else:
        want = jrun.evaluate_semseg(lambda v, p: next(calls), None, batches)
        got = trun.evaluate_semseg(lambda p: torch.from_numpy(next(calls)), batches)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


@pytest.mark.parametrize("task", ["partseg", "semseg"])
def test_runner_trains_saves_and_reloads(tmp_path, task):
    """Two steps and one evaluation on the CPU: finite losses, every trained
    tensor and running statistic moved, ckpt-best written, and reloaded it
    gives the trained model's eval log-probs bit for bit."""
    run = trun.run_partseg if task == "partseg" else trun.run_semseg
    res = run(root=str(tmp_path / "none"), npoint=NPOINT, batch_size=4, epoch=1,
              num_group=G, experiment_path=str(tmp_path / "exp"), device="cpu", max_steps=2,
              eval_batches=2)
    assert res.steps == 2 and len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert len(res.epoch_metrics) == 1 and 0.0 < res.best <= 1.0
    model = res.state.model
    init = load_seg_model(task, num_group=G, device="cpu").state_dict()
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    assert not [n for n in trained if torch.equal(model.state_dict()[n], init[n])]
    assert all(not torch.equal(t, init[k]) for k, t in model.state_dict().items() if "running" in k)
    path = tmp_path / "exp" / "ckpt-best.pth"
    assert path.exists()
    reloaded = load_seg_model(task, str(path), num_group=G, device="cpu")
    pts = tds.PartNormalDataset("/nope", NPOINT, "test")[3][0][None]
    extra = (np.eye(16, dtype=np.float32)[[3]],) if task == "partseg" else ()
    assert torch.equal(build_infer_fn(reloaded, NPOINT, with_fps=False)(pts, *extra),
                       build_infer_fn(model.eval(), NPOINT, with_fps=False)(pts, *extra))


def test_pretrained_student_merges_into_the_backbone(tmp_path):
    """``ckpts`` lifts the student prefixes and merges by name and shape
    (the counterpart of ``_remap_backbone``): the backbone takes the
    checkpoint's tensors, the head keeps its seeded ones."""
    donor = load_seg_model("semseg", num_group=G, seed=5, device="cpu").state_dict()
    sd = {f"ACT_encoder.{k}": v for k, v in donor.items()
          if k.startswith(("encoder.", "blocks.", "pos_embed.", "norm."))}
    torch.save({"base_model": sd}, tmp_path / "pretrain.pth")
    st = trun.build_seg_state("semseg", 4, num_group=G, ckpts=str(tmp_path / "pretrain.pth"),
                              device="cpu")
    got, seeded = st.model.state_dict(), load_seg_model("semseg", num_group=G, device="cpu")
    for k, v in got.items():
        src = donor if f"ACT_encoder.{k}" in sd else seeded.state_dict()
        assert torch.equal(v, src[k]), k
    assert len(sd) > 100


def test_whole_scene_batched_equals_per_block(tmp_path):
    model = load_seg_model("semseg", num_group=G, dtype="f32", seed=2, device="cpu")
    runs = {bs: trun.whole_scene_eval(model, root=str(tmp_path / "none"), npoint=512,
                                      eval_batch_size=bs, vote_num=1, device="cpu")
            for bs in (1, 16)}
    (m1, v1), (m16, v16) = runs[1], runs[16]
    assert len(v1) == len(v16) == 2
    for a, b in zip(v1, v16):
        assert a.shape == b.shape and (a.sum(-1) > 0.99).all()  # every point voted
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    for k in m1:
        assert m16[k] == pytest.approx(m1[k], abs=1e-6), k


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "none")
    for call in (lambda: trun.run_partseg(root=root, experiment_path=str(tmp_path)),
                 lambda: trun.run_semseg(root=root, experiment_path=str(tmp_path)),
                 lambda: trun.whole_scene_eval(root=root),
                 lambda: semantic_segmentation_test.main(["--root", root])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_clis_train_and_vote(tmp_path, monkeypatch):
    """The three CLIs on the CPU in a working directory of their own: the
    part-seg and sem-seg trainers write ckpt-best and their logs, and the
    whole-scene vote loads the sem-seg ckpt-best."""
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--steps", "1", "--epoch", "1", "--npoint", str(NPOINT),
              "--num_group", str(G), "--batch_size", "2", "--root", "none"]
    part_segmentation.main(common + ["--log_dir", "p"])
    semantic_segmentation.main(common + ["--log_dir", "s"])
    for path in ("work_dirs/part_seg/p", "work_dirs/sem_seg/s"):
        assert (tmp_path / path / "ckpt-best.pth").exists()
        assert (tmp_path / path / "train.log").stat().st_size > 0
    semantic_segmentation_test.main(
        ["--device", "cpu", "--npoint", "1024", "--num_group", str(G), "--root", "none",
         "--num_votes", "1", "--log_dir", "s", "--ckpts", "work_dirs/sem_seg/s/ckpt-best.pth"])
    assert "[WHOLE-SCENE]" in (tmp_path / "work_dirs/sem_seg/s/test.log").read_text()


class NumpySpy(types.ModuleType):
    """numpy, but every array ``zeros`` makes is kept in ``made``."""

    def __init__(self):
        super().__init__("numpy")
        self.made = []

    def __getattr__(self, name):
        return getattr(np, name)

    def zeros(self, *args, **kwargs):
        self.made.append(np.zeros(*args, **kwargs))
        return self.made[-1]


def test_whole_scene_vote_matches_jax(tmp_path, monkeypatch):
    """Both ``whole_scene_eval``s on the same synthetic scenes, 16 blocks a
    forward, one vote round. The weights are JAX's perturbed f32 sem-seg
    ones carried over by ``seg_state_dict``, with every BatchNorm's running
    statistics set to those of one batch of the scene's blocks (with the
    perturbed statistics every point votes for the same class, and a wrong
    point mapping or metric could not show), then converted back for JAX by
    its ``convert_state_dict``. JAX returns only the metrics: its vote pools
    are the (points, 13) arrays its ``np.zeros`` makes, which ``np.add.at``
    fills in place."""
    root = str(tmp_path / "none")
    model = port_model("semseg", jax_variables("semseg"))
    blocks = [b for b, _, _ in tds.WholeSceneDataset(root, NPOINT).blocks_for_scene(0)][:32]
    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.momentum = 1.0  # running statistics := this batch's
        m.train()
    with torch.no_grad():
        model(torch.from_numpy(np.stack(blocks)))
    model.eval()
    params, stats = convert_state_dict({k: t.numpy() for k, t in model.state_dict().items()},
                                       seg_rules(False))
    spy = NumpySpy()
    monkeypatch.setattr(jrun, "np", spy)
    args = SimpleNamespace(root=root, npoint=NPOINT, test_area=5, eval_batch_size=16)
    want = jrun.whole_scene_eval(
        args, state=SimpleNamespace(variables=lambda: {"params": params, "batch_stats": stats}),
        model=JSemSeg(JConfigDict(model_cfg("semseg"))), vote_num=1)
    monkeypatch.undo()
    pools = [a for a in spy.made if a.ndim == 2]
    got, votes = trun.whole_scene_eval(model, root=root, npoint=NPOINT, eval_batch_size=16,
                                       vote_num=1, device="cpu")
    assert len(votes) == len(pools) == 2
    for a, b in zip(votes, pools):
        assert a.shape == b.shape and (b.sum(-1) > 0.99).all()  # every point voted
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        top2 = np.sort(b, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert clear.mean() > 0.99 and len(np.unique(b.argmax(-1))) >= 8
        np.testing.assert_array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear])
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k
