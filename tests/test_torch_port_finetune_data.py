"""The port's finetune data, runner and checkpoints held against the JAX package.

The datasets serve the same synthetic samples, labels and train-time point
shuffles as the JAX classes, and the loader batches them in the same order
(numpy on both sides: exact). ``validate`` and the vote run a small
PointTransformer (``tests/test_torch_port_finetune.py``) with the JAX
weights carried over; the vote's draws are pinned to the JAX keys'. The
pretrained merge of a small Stage-II checkpoint gives the same state dict
on both sides, tensor for tensor. Tolerances: predictions, accuracies and
merged tensors exact; eval logits and summed vote probabilities within 1e-5
(f32, eval mode, only sum order differs).
"""
import itertools
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from sklearn.metrics import balanced_accuracy_score

from act_tpu.datasets import build as jdatasets_build
from act_tpu.datasets import pointcloud_datasets as jpcd
from act_tpu.datasets.loader import DataLoader as JDataLoader
from act_tpu.engine import checkpoint as jckpt
from act_tpu.engine import runner_finetune as jrunner
from act_tpu.engine.train_state import TrainState
from act_tpu.models import ACT_PointDistillation as JDistill
from act_tpu.utils.config import ConfigDict as JConfigDict
from act_tpu.utils.meters import AverageMeter as JAverageMeter

from act_tpu_torch import ops
from act_tpu_torch.datasets import DATASETS, DataLoader, build_dataset_from_cfg
from act_tpu_torch.datasets.pointcloud_datasets import farthest_point_sample_np, shuffle_rows
from act_tpu_torch.engine import weights
from act_tpu_torch.engine import checkpoint as ckpt_lib
from act_tpu_torch.engine import runner_finetune as runner
from act_tpu_torch.models import MODELS
from act_tpu_torch.utils.config import ConfigDict
from act_tpu_torch.utils.meters import AverageMeter, balanced_accuracy

from tests.test_torch_port_finetune import N_PTS, jax_model, port_model, tiny_cfg, train_cfg
from tests.test_torch_port_stage2 import jax_variables
from tests.test_torch_port_stage2 import tiny_cfg as distill_cfg

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

NPOINTS = 128  # the resample target of the small runs: FPS 256 -> 128

DATASET_NODES = {
    "ModelNet": dict(NAME="ModelNet", DATA_PATH="data/absent", N_POINTS=N_PTS,
                     NUM_CATEGORY=40),
    "ModelNetFewShot": dict(NAME="ModelNetFewShot", DATA_PATH="data/absent",
                            N_POINTS=N_PTS, way=5, shot=10, fold=0),
    "ScanObjectNN": dict(NAME="ScanObjectNN", ROOT="data/absent"),
    "ScanObjectNN_hardest": dict(NAME="ScanObjectNN_hardest", ROOT="data/absent"),
}


def dataset_node(name, subset):
    return {"_base_": DATASET_NODES[name], "others": {"subset": subset}}


def small_run_cfg(transfer="mlp-3", bs=4):
    cfg = train_cfg(dict(tiny_cfg(transfer), cls_dim=40))  # ModelNet's 40 classes
    cfg.update(npoints=NPOINTS, total_bs=bs, max_epoch=300,
               dataset={s: dataset_node("ModelNet", sub) for s, sub in
                        (("train", "train"), ("val", "test"), ("test", "test"))})
    return ConfigDict(cfg)


# ---------------------------------------------------------------------------
# datasets and the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DATASET_NODES))
@pytest.mark.parametrize("subset", ["train", "test"])
def test_synthetic_datasets_match_jax(name, subset):
    """Same length, samples and labels; in the train subset the same point
    shuffles, sample after sample."""
    node = dataset_node(name, subset)
    want = jdatasets_build.build_dataset_from_cfg(JConfigDict(node))
    got = build_dataset_from_cfg(ConfigDict(node))
    assert type(got).__name__ == name and name in DATASETS
    assert got.synthetic and len(got) == len(want)
    for i in (0, 1, 7, 1, len(want) - 1):
        (wt, wm, (wp, wl)), (gt, gm, (gp, gl)) = want[i], got[i]
        assert (gt, gm, gl) == (wt, wm, wl) and isinstance(gl, int)
        assert gp.dtype == np.float32 and np.array_equal(gp, wp), (i, gt)


@pytest.mark.parametrize("shape", [(8192, 3), (8192, 6), (2048, 3), (2, 3), (1, 6)])
def test_shuffle_rows_is_generator_shuffle(shape):
    """The datasets' row shuffle leaves the rows where ``Generator.shuffle``
    does and the generator in the same state."""
    pts = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want, r1, r2 = pts.copy(), np.random.default_rng(5), np.random.default_rng(5)
    r1.shuffle(want)
    got = shuffle_rows(r2, pts)
    assert np.array_equal(got, want) and np.array_equal(r1.random(4), r2.random(4))


def test_loader_order_and_length():
    """Shuffled by (seed, epoch), the last partial batch dropped for train;
    in order with it kept otherwise; batch for batch the JAX loader's."""
    for subset, shuffle in (("train", True), ("test", False)):
        node = dataset_node("ModelNetFewShot", subset)
        jds = jdatasets_build.build_dataset_from_cfg(JConfigDict(node))
        tds = build_dataset_from_cfg(ConfigDict(node))
        jl = JDataLoader(jds, 16, shuffle=shuffle, drop_last=shuffle, seed=3, prefetch=0)
        tl = DataLoader(tds, 16, shuffle=shuffle, drop_last=shuffle, seed=3)
        assert len(tl) == len(jl) == (len(tds) // 16 if shuffle else -(-len(tds) // 16))
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            n = 0
            for (_, _, (wp, wl)), (_, _, (gp, gl)) in zip(jl, tl):
                assert np.array_equal(gp, wp) and np.array_equal(gl, wl)
                assert gl.dtype == np.int32
                n += 1
            assert n == len(tl)
        assert len(tds) == (50 if shuffle else 100)


def test_dataset_builder_and_cls_dim_from_way():
    cfg = small_run_cfg(bs=8)
    train, val = runner.loaders(cfg)
    assert (train.batch_size, train.shuffle, train.drop_last) == (8, True, True)
    assert (val.batch_size, val.shuffle, val.drop_last) == (16, False, False)
    assert len(train) == 512 // 8 and len(val) == 512 // 16
    few = runner.finetune_config("cfgs/finetune_classification/few_shot/fewshot_modelnet.yaml",
                                 way=5, shot=10, fold=2)
    assert few.model.cls_dim == 5
    assert (few.dataset.train.others.way, few.dataset.val.others.fold) == (5, 2)
    full = runner.finetune_config("cfgs/finetune_classification/full/finetune_modelnet.yaml",
                                  way=5, shot=10)
    assert full.model.cls_dim == 40


def test_host_fps_matches_jax(rng):
    pts = rng.normal(size=(700, 6)).astype(np.float32)
    np.testing.assert_array_equal(farthest_point_sample_np(pts, 64),
                                  jpcd.farthest_point_sample_np(pts, 64))


def test_balanced_accuracy_matches_sklearn(rng):
    for n_cls in (2, 7, 40):
        labels = rng.integers(0, n_cls, 300)
        preds = np.where(rng.random(300) < 0.6, labels, rng.integers(0, n_cls + 3, 300))
        assert math.isclose(balanced_accuracy(labels, preds),
                            balanced_accuracy_score(labels, preds), rel_tol=1e-12)


def test_average_meter_matches_jax(rng):
    values = rng.normal(size=(5, 2))
    got, want = AverageMeter(["loss", "acc"]), JAverageMeter(["loss", "acc"])
    for v in values:
        got.update(list(v))
        want.update(list(v))
    assert [got.avg(i) for i in range(2)] == [want.avg(i) for i in range(2)]


# ---------------------------------------------------------------------------
# validation and the vote
# ---------------------------------------------------------------------------

def small_models(rng, transfer="mlp-3"):
    jm, v = jax_model(tiny_cfg(transfer), rng)
    return jm, v, port_model(tiny_cfg(transfer), v).eval()


def val_batches(n_batches=2, bs=8):
    ds = build_dataset_from_cfg(ConfigDict(dataset_node("ModelNet", "test")))
    return list(itertools.islice(DataLoader(ds, bs), n_batches))


def test_validate_matches_jax(rng):
    jm, v, model = small_models(rng)
    batches = val_batches()
    state = TrainState.create(v, optax.sgd(0.0))
    infer = jax.jit(lambda variables, pts: jm.apply(variables, jrunner.ops.gather_points(
        pts, jrunner.ops.furthest_point_sample(pts, NPOINTS))))
    want_p, want_l = jrunner._gather_eval(jm, state, batches, infer)
    got, got_l = runner.predict(model, batches, NPOINTS, "cpu")
    want = np.concatenate([np.asarray(infer(state.variables(), jnp.asarray(b[2][0])))
                           for b in batches])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want_p)
    np.testing.assert_array_equal(got_l, want_l)
    acc = runner.validate(model, batches, NPOINTS, "cpu")
    assert acc.acc == jrunner.validate(jm, state, batches, infer, None).acc
    assert math.isclose(acc.macc, balanced_accuracy_score(want_l, want_p) * 100.0,
                        rel_tol=1e-12)


class VoteDraws:
    """The JAX vote's draws for (round, batch), replayed in the port's call
    order through ``ops.fps_subsample`` and ``scale_and_translate``."""

    def __init__(self, monkeypatch, B, n_fps):
        self.B, self.n_fps, self.queue = B, n_fps, []
        monkeypatch.setattr(ops, "fps_subsample",
                            lambda pts, nf, n_out, gen: ops.fps_subsample_by(
                                pts, nf, self.queue.pop(0)))
        monkeypatch.setattr(runner, "scale_and_translate",
                            lambda p, gen: p * self.queue.pop(0) + self.queue.pop(0))

    def load(self, key, times):
        """The draws of ``split(key, times)``, as ``make_vote_logits`` takes them."""
        for vk in jax.random.split(key, times):
            k1, k2 = jax.random.split(vk)
            keys = jax.random.split(k1, self.B)
            sub = jax.vmap(lambda kk: jax.random.permutation(kk, self.n_fps)[:NPOINTS])(keys)
            ka, kb = jax.random.split(k2)
            scale = jax.random.uniform(ka, (self.B, 1, 3), minval=2.0 / 3.0, maxval=1.5)
            shift = jax.random.uniform(kb, (self.B, 1, 3), minval=-0.2, maxval=0.2)
            self.queue += [torch.from_numpy(np.array(sub, np.int32)),
                           torch.from_numpy(np.array(scale)), torch.from_numpy(np.array(shift))]


def test_validate_vote_matches_jax(rng, monkeypatch):
    jm, v, model = small_models(rng)
    batches = val_batches(2)
    state = TrainState.create(v, optax.sgd(0.0))
    root = jax.random.PRNGKey(4)
    times = 3
    draws = VoteDraws(monkeypatch, 8, NPOINTS)
    # one batch's summed probabilities
    pts = jnp.asarray(batches[0][2][0])
    keys = jax.random.split(jax.random.fold_in(root, 0), times)
    want = np.asarray(jrunner.make_vote_logits(jm, NPOINTS)(state.variables(), pts, keys))
    draws.load(jax.random.fold_in(root, 0), times)
    with torch.inference_mode():
        got = runner.vote_logits(model, torch.from_numpy(np.array(pts)), NPOINTS, None, times)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not draws.queue
    # the vote accuracy over the batches, and two test rounds
    want_acc = jrunner.validate_vote(jm, state, batches, NPOINTS, root, None, times=times)
    for i in range(len(batches)):
        draws.load(jax.random.fold_in(root, i), times)
    assert runner.validate_vote(model, batches, NPOINTS, times=times, device="cpu") == want_acc
    want_r = jrunner.test_vote_rounds(jm, state, batches, NPOINTS, root, None, rounds=2,
                                      times=times)
    for r in range(2):
        for i in range(len(batches)):
            draws.load(jax.random.fold_in(jax.random.fold_in(root, r), i), times)
    np.testing.assert_array_equal(runner.test_vote_rounds(model, batches, NPOINTS, 0, 2,
                                                          times, "cpu"), want_r)


def test_test_vote_rounds_is_validate_vote_per_round(rng):
    _, _, model = small_models(rng)
    batches = val_batches(1, 4)
    got = runner.test_vote_rounds(model, batches, NPOINTS, 5, 3, times=2, device="cpu")
    want = [runner.validate_vote(model, batches, NPOINTS, 5, 2, r, "cpu") for r in range(3)]
    assert got.tolist() == want
    g0 = runner.vote_generator(5, 0, 0, "cpu").initial_seed()
    assert g0 != runner.vote_generator(5, 1, 0, "cpu").initial_seed()
    assert g0 != runner.vote_generator(5, 0, 1, "cpu").initial_seed()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_pretrained_merge_matches_jax(rng):
    """A Stage-II checkpoint merged into the classifier: the JAX merge of its
    flax tree and the port's merge of its state dict give the same tensors;
    the student's pretraining head is unexpected on both sides."""
    pts = rng.normal(size=(2, 128, 3)).astype(np.float32)
    dv = jax_variables(JDistill(distill_cfg()), rng, pts)
    jm, v, model = small_models(rng, "full")
    params = jckpt.merge_pretrained(v["params"], jckpt.strip_student_prefix(dv["params"]))
    stats = jckpt.merge_pretrained(v["batch_stats"],
                                   jckpt.strip_student_prefix(dv["batch_stats"]))
    want = weights.flax_to_state_dict(params, stats)
    j_unexpected = set(jckpt.report_key_diff(
        params, jckpt.strip_student_prefix(dv["params"]))[1])
    loaded = ckpt_lib.strip_student_prefix(
        weights.distillation_state_dict(dv["params"], dv["batch_stats"]))
    missing, unexpected = ckpt_lib.merge_pretrained(model, loaded)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, x in got.items():
        assert torch.equal(x, want[k]), k
    assert {"cls_head.layers_0.kernel", "cls_head.layers_2.bias"} <= j_unexpected
    assert {"cls_head.0.weight", "cls_head.2.bias"} <= set(unexpected)
    assert all(k.startswith("cls_head_finetune.") for k in missing)
    assert torch.equal(got["blocks.blocks.1.mlp.fc2.weight"],
                       loaded["blocks.blocks.1.mlp.fc2.weight"])


def test_run_net_validates_and_saves_last_every_epoch(tmp_path, monkeypatch):
    """Each epoch ends in a validation and a ckpt-last save: the reference
    runner's cadence, the JAX runner's at its default ``--val_freq 1`` and
    ``--ckpt_every 1``."""
    saves, validations = [], []
    save, validate = ckpt_lib.save_checkpoint, runner.validate

    def recording_save(*args):
        saves.append((args[6], args[3]))  # (prefix, epoch)
        return save(*args)

    def recording_validate(*args):
        validations.append(args[2])
        return validate(*args)
    monkeypatch.setattr(ckpt_lib, "save_checkpoint", recording_save)
    monkeypatch.setattr(runner, "validate", recording_validate)
    res = runner.run_net(small_run_cfg(bs=8), device="cpu", epochs=2, max_steps=1,
                         experiment_path=str(tmp_path))
    assert res.steps == 2 and validations == [NPOINTS, NPOINTS]
    assert [e for prefix, e in saves if prefix == "ckpt-last"] == [0, 1]
    assert torch.load(tmp_path / "ckpt-last.pth", weights_only=True)["epoch"] == 1


def test_save_resume_round_trip(tmp_path):
    """Three steps in one run, and two steps, a checkpoint, a resume and the
    third: the same losses and the same final state, bit for bit."""
    cfg = small_run_cfg()
    ds = build_dataset_from_cfg(ConfigDict(dataset_node("ModelNet", "train")))
    batches = list(itertools.islice(DataLoader(ds, 4, shuffle=True, drop_last=True), 3))
    whole = runner.run_finetune_steps(cfg, 3, batches=batches, device="cpu")
    first = runner.run_finetune_steps(cfg, 2, batches=batches, device="cpu")
    st = first.state
    ckpt_lib.save_checkpoint(st.model, st.optimizer, 2, 0, None, {"acc": 1.0}, "ckpt-last",
                             str(tmp_path))
    fresh = runner.build_state(cfg, 128, seed=0, device="cpu")
    assert not torch.equal(fresh.model.state_dict()["cls_head_finetune.0.weight"],
                           st.model.state_dict()["cls_head_finetune.0.weight"])
    epoch, step, best = ckpt_lib.resume_state(fresh.model, fresh.optimizer, str(tmp_path))
    assert (epoch, step, best) == (1, 2, {"acc": 1.0})
    rest = runner.run_finetune_steps(cfg, 1, batches=batches[2:], device="cpu", state=fresh,
                                     start_step=2)
    assert first.losses + rest.losses == whole.losses
    for k, x in whole.state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], x), k
    payload = torch.load(tmp_path / "ckpt-last.pth", weights_only=True)
    assert set(payload) == {"base_model", "optimizer", "step", "epoch", "metrics",
                            "best_metrics"}


def test_run_net_resume_and_test_net_on_cpu(tmp_path, capsys):
    cfg = small_run_cfg(bs=8)
    res = runner.run_net(cfg, device="cpu", epochs=1, max_steps=2, vote=True,
                         experiment_path=str(tmp_path))
    assert res.steps == 2 and all(math.isfinite(x) for x in res.epoch_loss)
    assert os.path.exists(tmp_path / "ckpt-last.pth")
    again = runner.run_net(cfg, device="cpu", epochs=2, max_steps=1, resume=True,
                           experiment_path=str(tmp_path))
    assert again.steps == 3 and len(again.epoch_loss) == 1
    assert "[RESUME] resumed at epoch 1" in capsys.readouterr().out
    acc = runner.test_net(cfg, ckpts=str(tmp_path / "ckpt-last.pth"), device="cpu")
    want = runner.validate(again.state.model, runner.loaders(cfg, 0, ("test",))[0], NPOINTS,
                           "cpu")
    assert acc.acc == want.acc and math.isfinite(acc.macc)


def test_cli_steps_on_cpu(tmp_path, capsys):
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(
        "optimizer: {type: AdamW, kwargs: {lr: 0.0005, weight_decay: 0.05}}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 300, initial_epochs: 10}}\n"
        "dataset:\n"
        "  train: {_base_: cfgs/dataset_configs/ModelNet40.yaml, others: {subset: train, "
        f"N_POINTS: {N_PTS}}}}}\n"
        "model: {NAME: PointTransformer, embed_dim: 32, depth: 2, drop_path_rate: 0.1, "
        "cls_dim: 40, num_heads: 4, group_size: 8, num_group: 16, encoder_dims: 32}\n"
        f"npoints: {NPOINTS}\ntotal_bs: 4\ngrad_norm_clip: 10\n")
    runner.main(["--config", str(yaml), "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1: loss" in out


def test_entry_points_default_to_the_card():
    """No hidden fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = small_run_cfg()
    model = MODELS.build(ConfigDict(tiny_cfg())).eval()
    for call in (lambda: runner.run_finetune_steps(cfg, 1),
                 lambda: runner.run_net(cfg, epochs=1),
                 lambda: runner.test_net(cfg),
                 lambda: runner.build_state(cfg, 1),
                 lambda: runner.validate(model, val_batches(1, 2), NPOINTS),
                 lambda: runner.validate_vote(model, val_batches(1, 2), NPOINTS)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
