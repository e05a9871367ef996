"""The port's measurement tools held against the JAX package's on the CPU.

``act_tpu_torch.graft_entry``, ``bench``, ``bench_suite`` and
``bench_sustained`` against ``__graft_entry__.py``, ``bench.py``,
``tools/bench_suite.py`` and ``tools/bench_sustained.py``, on the same
seeded inputs at small sizes:

- (a) ``pretrain_cfg`` equals JAX's ``_pretrain_cfg`` at both widths; the
  entry's forward at the tiny config (drop path 0, prompt dropout off on
  both sides, the sown mask and Gumbel draws replayed) on JAX's materialised
  variables equals JAX's entry forward within 1e-5 (f32, sum order), and
  the port's ``materialize`` gives every 1-D tensor the value JAX's gives it;
- (b) ``dryrun_multichip(2, device="cpu")``: JAX's lines, every leg's
  tensors that are not shards bit-equal on both ranks (the tool raises
  otherwise) and the ranks' losses equal; the distillation leg's loss within
  1e-5 of ``distill_step`` in one process on the global batch, its Gumbel
  rows drawn as each rank draws them (``fold_seed`` a rank's rows);
- (c) the three microbench closures equal JAX's ops on the same clouds: FPS
  indices and kNN indices exactly, distances and the Chamfer loss within
  1e-6;
- (d) ``build_tree`` byte-equal to JAX's, the loader's first two batches
  (seed 0, shuffled, no workers) equal JAX's ``DataLoader``'s, the clouds
  of an epoch equal to JAX's count, and ``bench_e2e`` on the tiny model;
- (e) ``bench`` at the tiny config, B=2, 2 steps on the CPU: one JSON line
  with every key and the CPU named, the device numbers null; the steps it
  times are the workload's (the same losses as a direct run on the same
  batches); ``step_flops`` exactly the count of the step's products and the
  kernels' formulas, twice at B=4, between one and three forwards;
- (f) ``bench_suite --only`` keeps the other rows of ``--out`` and refuses
  a file whose header names another device.
"""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from act_tpu import ops as jops
from act_tpu.datasets import DataLoader as JDataLoader
from act_tpu.datasets.pointcloud_datasets import ShapeNet as JShapeNet
from act_tpu.models import MODELS as JMODELS
from act_tpu.models import common as jcommon
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import bench, bench_suite, bench_sustained, get_flops, graft_entry, ops
from act_tpu_torch import profile_step
from act_tpu_torch.engine import runner_pretrain, weights
from act_tpu_torch.engine.train_state import step_rngs
from act_tpu_torch.models import act, common
from act_tpu_torch.ops import sampling, work
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_stage2_run import pretrain_cfg as run_pretrain_cfg
from tests.test_torch_port_stage2_run import shapenet_node

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """A JAX tool of ``tools/`` (a directory, not a package) as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain(node):
    return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}


# ---------------------------------------------------------------------------
# (a) the entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiny", [True, False])
def test_pretrain_cfg_equals_jax(tiny):
    assert plain(graft_entry.pretrain_cfg(tiny)) == plain(graft._pretrain_cfg(tiny))


def test_entry_forward_matches_jax(monkeypatch):
    jax_cfg = graft._pretrain_cfg

    def tiny_cfg(tiny=False):
        cfg = jax_cfg(tiny=True)
        cfg.transformer_config.drop_path_rate = 0.0
        return cfg
    monkeypatch.setattr(graft, "_pretrain_cfg", tiny_cfg)
    monkeypatch.setattr(graft_entry, "pretrain_cfg",
                        lambda tiny=False: ConfigDict(plain(tiny_cfg())))
    monkeypatch.setattr(jcommon.FastDropout, "__call__", lambda self, x, deterministic=True: x)
    monkeypatch.setattr(common.Dropout, "forward", lambda self, x, rngs=None: x)

    forward, (variables, pts) = graft.entry()
    want = float(jax.jit(forward)(variables, pts))
    jm = JMODELS.build(tiny_cfg())
    _, inter = jax.jit(lambda v, p: jm.apply(v, p, train=True, rngs=graft._rngs(1),
                                             mutable=["batch_stats", "intermediates"]))(
        variables, pts)
    inter = inter["intermediates"]
    mask = torch.from_numpy(np.array(inter["mask"][0]))
    u = torch.from_numpy(np.array(inter["dvae_tokenizer"]["gumbel_u"][0]))

    fwd, (model, got_pts) = graft_entry.entry("cpu")
    assert model.training and tuple(got_pts.shape) == (8, 1024, 3) and not got_pts.any()
    v = jax.device_get(variables)
    bridged = weights.distillation_state_dict(v["params"], v["batch_stats"])
    mine = model.state_dict()
    assert sorted(mine) == sorted(bridged)
    for k, x in mine.items():  # the materialize rule, tensor by tensor
        if x.dim() <= 1:
            assert torch.equal(x.float(), torch.as_tensor(np.asarray(bridged[k])).float()), k
        else:
            assert abs(float(x.float().std()) - 0.02) < 0.01, k
    model.load_state_dict(bridged, strict=True)
    monkeypatch.setattr(act, "random_mask", lambda g, B, G, n: mask)
    monkeypatch.setattr(ops, "gumbel_argmax", lambda logits, seed: torch.argmax(
        logits - torch.log(-torch.log(u)), dim=-1))
    with torch.no_grad():
        got = float(fwd(model, got_pts))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# (b) the dry run over two ranks
# ---------------------------------------------------------------------------

def test_dryrun_multichip_two_ranks(monkeypatch, capsys):
    run = graft_entry.dryrun_multichip(2, device="cpu")
    legs = run["legs"]
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "dryrun_multichip(2): mesh={'data': 2, 'model': 1} all graphs OK"
    assert list(legs) == ["distill", "tp", "dvae", "finetune", "pointbert", "semseg", "partseg"]
    for leg, rec in legs.items():
        assert len(set(rec["losses"])) == 1 and np.isfinite(rec["loss"]), leg
        assert any(line.startswith(f"dryrun {leg} mesh=") and line.endswith("OK")
                   for line in out), leg
        assert rec["digests"], leg
    assert legs["tp"]["mesh"] == {"data": 1, "model": 2}
    assert legs["pointbert"]["note"].startswith("queue_ptr=4 ")
    assert len(run["launches"]) == 2  # each rank's kernel launches: none on the CPU
    assert not any(n for r in run["launches"] for n in r.values())

    # the distillation leg against one process on the global batch of B = 4
    fold = ops.gumbel_argmax

    def by_rank(logits, seed):  # rank r's rows with rank r's folded seed
        return torch.cat([fold(rows, sampling.fold_seed(seed, r))
                          for r, rows in enumerate(logits.chunk(2))])
    monkeypatch.setattr(ops, "gumbel_argmax", by_rank)
    loss, _ = graft_entry.distill_step(graft_entry.global_batch(0, 4), torch.device("cpu"))
    np.testing.assert_allclose(legs["distill"]["loss"], loss, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# (c) the microbench closures
# ---------------------------------------------------------------------------

JAX_MICRO = {"fps": lambda x: jops.furthest_point_sample(x, 64),
             "knn": lambda x: jops.knn(x, x[:, :64], 32),
             "chamfer": lambda x: jops.chamfer_distance_l1(x, x[:, ::-1] + 0.01)}


@pytest.mark.parametrize("key,shape", [("fps", (2, 256, 3)), ("knn", (2, 256, 3)),
                                       ("chamfer", (2, 256, 3))])
def test_microbench_closures_match_jax(key, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _, _, fn, plain_fn = bench_suite.MICROBENCHES[key]
    got, again = fn(torch.from_numpy(x)), plain_fn(torch.from_numpy(x))
    want = JAX_MICRO[key](jnp.asarray(x))
    got, again = (got if isinstance(got, tuple) else (got,)), (
        again if isinstance(again, tuple) else (again,))
    want = want if isinstance(want, tuple) else (want,)
    for g, a, w in zip(got, again, want):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
        assert torch.equal(g, a)


# ---------------------------------------------------------------------------
# (d) the sustained tool's tree, loader and epoch
# ---------------------------------------------------------------------------

def test_tree_loader_and_epoch_match_jax(tmp_path, capsys):
    jax_sustained = jax_tool("bench_sustained")
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    bench_sustained.build_tree(str(mine), 8, 64)
    jax_sustained.build_tree(str(theirs), 8, 64)
    files = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 8 + 3
    for f in files:
        assert (mine / f).read_bytes() == (theirs / f).read_bytes(), f
    bench_sustained.build_tree(str(mine), 8, 64)
    assert "reusing" in capsys.readouterr().out

    jds = JShapeNet(JConfigDict(dict(NAME="ShapeNet", N_POINTS=8192, DATA_PATH=str(theirs),
                                     PC_PATH=str(theirs / "shapenet_pc"), subset="train",
                                     npoints=32)))
    assert not jds.synthetic
    jdl = JDataLoader(jds, 2, shuffle=True, drop_last=True, seed=0, prefetch=2, num_workers=0)
    dl = bench_sustained.loader(str(mine), 2, 32, 0)
    for (jt, jm, jp), (t, m, p) in zip(list(jdl)[:2], list(dl)[:2]):
        assert list(jt) == list(t) and list(jm) == list(m)
        np.testing.assert_array_equal(p, jp)
    dl.close()
    assert bench_sustained.bench_loader(str(mine), 2, 32, 2, 0) > 0
    with pytest.raises(FileNotFoundError, match="synthetic"):
        bench_sustained.loader(str(tmp_path / "absent"), 2, 32, 0)

    # an epoch: the JAX tool's count (whole: test.txt's lines first, then train.txt's)
    cfg = run_pretrain_cfg(shapenet_node("train", str(mine), str(mine / "shapenet_pc"),
                                         npoints=32, whole=True, n_points=8192), bs=4)
    del cfg.dataset["val"], cfg.dataset["extra_train"]
    cfg.max_epoch = 2
    base, others = cfg.dataset.train._base_, cfg.dataset.train.others
    n_total = len(JShapeNet(JConfigDict({**dict(base), "subset": others.get("subset", "train"),
                                         "whole": bool(others.get("whole", False)),
                                         "npoints": int(others.npoints)})))
    assert n_total == 16
    assert bench_sustained.clouds_per_epoch(cfg) == (n_total // 4) * 4
    e2e = bench_sustained.bench_e2e(cfg, 0, "cpu")
    assert len(e2e["epoch_times_s"]) == 2 and e2e["clouds"] == 32
    assert e2e["clouds_per_sec"] == 16 / e2e["epoch_times_s"][1]


# ---------------------------------------------------------------------------
# (e) the headline
# ---------------------------------------------------------------------------

def tiny_pretrain():
    cfg = run_pretrain_cfg(shapenet_node("train"))
    del cfg.dataset["val"], cfg.dataset["extra_train"]
    return cfg


def test_bench_line_times_the_workload_step(monkeypatch):
    real, made = profile_step.setup_pretrain, []

    def recording(device="cuda", config=None, B=128):
        wl = real(device, tiny_pretrain(), B)
        step, losses = wl.step, []
        wl.step = lambda i, pts: losses.append((i, float(step(i, pts)))) or losses[-1][1]
        made.append(losses)
        return wl
    monkeypatch.setattr(profile_step, "setup_pretrain", recording)
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_STEPS", "2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--warmup", "1", "--device", "cpu"])
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "mfu", "step_flops", "step_ms", "device_ms", "idle",
            "peak_gib", "device", "power_limit"} <= set(rec)
    assert rec["metric"] == "pretrain_clouds_per_sec_per_chip"
    assert rec["device"] == {"platform": "cpu", "name": "cpu", "count": 1}
    assert rec["mfu"] is None and rec["device_ms"] is None and rec["power_limit"] is None
    assert rec["value"] == pytest.approx(2 / rec["step_ms"] * 1e3)
    # the count's step on batch 0, one warm-up step and the two timed steps on theirs
    (timed,) = made
    assert [i for i, _ in timed] == [0, 0, 1, 2]
    direct = real("cpu", tiny_pretrain(), 2)
    batches = [direct.batch(0)] + [direct.batch(1000 + i) for i in range(3)]
    assert [x for _, x in timed] == [float(direct.step(i, b))
                                     for i, b in zip([0, 0, 1, 2], batches)]


def test_step_flops_exact_and_linear_in_batch():
    """The step's count is its products and the kernels' formulas; the
    frozen tokenizer runs no backward, so a step counts less than three
    forwards (and more than one)."""
    counts = {}
    for B in (2, 4):
        wl = profile_step.setup_pretrain("cpu", tiny_pretrain(), B)
        pts = wl.batch(0)
        cfg = tiny_pretrain()
        model = runner_pretrain.prepare_model(cfg, 0, "cpu").train()  # the step's model
        with torch.no_grad():
            fwd, _ = get_flops.counted(lambda: model(pts, rngs=step_rngs(0, 0, "cpu")))
        aten, kernels = get_flops.counted(lambda: wl.step(0, pts))
        assert {k: n for k, n in kernels.items() if n} == {
            "fps": work.fps(B, 128, 16), "gumbel_argmax": work.gumbel_argmax(B * 16, 64)}
        assert fwd < aten < 3 * fwd
        counts[B] = bench.count_step(profile_step.setup_pretrain("cpu", tiny_pretrain(), B))
        assert counts[B] == aten + sum(kernels.values())
    assert counts[4] == 2 * counts[2]


# ---------------------------------------------------------------------------
# (f) the suite's --only
# ---------------------------------------------------------------------------

def test_suite_only_keeps_rows_and_refuses_another_device(monkeypatch, tmp_path, capsys):
    label, _, fn, plain_fn = bench_suite.MICROBENCHES["fps"]
    monkeypatch.setitem(bench_suite.MICROBENCHES, "fps", (label, (2, 256, 3), fn, plain_fn))
    monkeypatch.setattr(bench_suite, "SUSTAINED_RECORD", str(tmp_path / "none.json"))
    out = tmp_path / "bench.md"
    kept = {k: f"| {k} | old row | 1 | 2.000 | 3.0 | 4 | 0.5 | 1.0 | 0.1 |"
            for k in bench_suite.KEYS if k != "fps"}
    out.write_text("# Benchmarks (cpu, single card; torch x, CUDA none)\n\n"
                   + "\n".join(kept.values()) + "\n| fps | old fps | 9.9 |\n")
    bench_suite.main(["--only", "fps", "--out", str(out), "--iters", "2", "--device", "cpu"])
    table = out.read_text()
    assert capsys.readouterr().out == table
    rows = bench_suite.read_rows(str(out))
    assert rows[0] == "cpu" and {k: rows[1][k] for k in kept} == kept
    assert rows[1]["fps"] != "| fps | old fps | 9.9 |" and rows[1]["fps"].startswith("| fps | ")
    other = tmp_path / "other.md"
    other.write_text("# Benchmarks (NVIDIA H100 80GB HBM3, 700.00 W, single card; torch x, "
                     "CUDA 12)\n\n| fps | old | 0.1 |\n")
    with pytest.raises(SystemExit, match="mix devices"):
        bench_suite.main(["--only", "fps", "--out", str(other), "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown --only"):
        bench_suite.main(["--only", "ops", "--device", "cpu"])
