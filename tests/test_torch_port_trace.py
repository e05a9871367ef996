"""The trace window, the step meters and the per-op profile of the port
(``act_tpu_torch/utils/profiling.py``, ``act_tpu_torch/profile_step.py``) on
the CPU.

``TraceContext`` does nothing without ``ACT_TPU_PROFILE``; with it a
4-step Stage-II ``run_net`` (``test_torch_port_stage2_run.py``'s
``pretrain_cfg``, no probe) with the window at steps [1, 3) writes one trace
holding exactly its 2 optimizer steps and ends bit-equal to the run without
the variable, in which no profiler starts; a preemption inside the window
still writes a whole trace. ``StepTimer`` and ``run_net``'s batch line
against JAX's ``StepTimer.summary`` and line format under a fixed clock, the
losses fetched only at the line's cadence. The report on a written
Kineto-format trace (both tables exact) and on a real CPU capture, and the
six ``setup_*`` builders at smoke width, one finite step each.
"""
import functools
import json
import os
import re
import time
import types

import numpy as np
import pytest
import torch

from act_tpu.utils import profiling as jprofiling
from act_tpu.utils.meters import AverageMeter as JAverageMeter

from act_tpu_torch import profile_step
from act_tpu_torch.engine import runner_pretrain as runner
from act_tpu_torch.engine.preemption import GUARD
from act_tpu_torch.utils import profiling

from tests.test_torch_port_dist_seg import WIDTHS
from tests.test_torch_port_finetune_data import small_run_cfg
from tests.test_torch_port_stage1 import VIT_CFG, smoke_cfg
from tests.test_torch_port_stage2_run import pretrain_cfg, shapenet_node

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

ADAMW = "Optimizer.step#AdamW.step"  # torch.optim's range around each step


def run_cfg():
    """The tiny distillation model on the synthetic ShapeNet-55 at B=4,
    without the probe's splits."""
    cfg = pretrain_cfg(shapenet_node("train"))
    del cfg.dataset["val"], cfg.dataset["extra_train"]
    return cfg


def run(tmp, steps=4, window=(1, 3)):
    """``run_net`` for ``steps`` steps of one epoch, the trace window at
    steps [window)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(runner, "TraceContext", functools.partial(profiling.TraceContext, *window))
        return runner.run_net(run_cfg(), device="cpu", epochs=1, max_steps=steps,
                              experiment_path=str(tmp))


def traces(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)) if os.path.isdir(d) else []


def annotations(path, name=ADAMW):
    with open(path) as f:
        data = json.load(f)
    return data, sum(e.get("cat") == "user_annotation" and e.get("name") == name
                     for e in data["traceEvents"])


@pytest.fixture
def guard():
    GUARD.reset()
    yield GUARD
    GUARD.reset()
    GUARD.at_step = None


# ---------------------------------------------------------------------------
# the trace window
# ---------------------------------------------------------------------------

def test_trace_context_does_nothing_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv(profiling.ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(profiling, "open_window", lambda *a: pytest.fail("a window opened"))
    trace = profiling.TraceContext(1, 3)
    for i in range(1, 6):
        trace.step(i)
    trace.close()
    assert trace.path is None and not os.listdir(tmp_path)


def test_run_net_traces_its_window_bit_equal_to_the_untraced_run(monkeypatch, tmp_path):
    """Unset: no window opens. Set: one trace of exactly the 2 steps of
    [1, 3) (its optimizer ranges and metadata), and the same losses,
    weights, optimizer state and checkpoint as the run without it."""
    monkeypatch.delenv(profiling.ENV, raising=False)
    with monkeypatch.context() as m:
        m.setattr(profiling, "open_window", lambda *a: pytest.fail("a window opened"))
        plain = run(tmp_path / "plain")
    out = tmp_path / "traces"
    monkeypatch.setenv(profiling.ENV, str(out))
    traced = run(tmp_path / "traced")
    (path,) = traces(out)
    assert path.endswith(profiling.TRACE_SUFFIX)
    data, n = annotations(path)
    assert n == 2 and data[profiling.STEPS_KEY] == "2"
    assert traced.epoch_loss == plain.epoch_loss and traced.step == plain.step == 4
    for k, x in plain.model.state_dict().items():
        assert torch.equal(traced.model.state_dict()[k], x), k
    a, b = plain.optimizer.state_dict()["state"], traced.optimizer.state_dict()["state"]
    for i, s in a.items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(b[i][name], s[name]), (i, name)
    ca = torch.load(tmp_path / "plain" / "ckpt-last.pth", weights_only=True)["base_model"]
    cb = torch.load(tmp_path / "traced" / "ckpt-last.pth", weights_only=True)["base_model"]
    assert all(torch.equal(cb[k], x) for k, x in ca.items())


def test_preemption_inside_the_window_leaves_a_closed_trace(monkeypatch, tmp_path, guard):
    out = tmp_path / "traces"
    monkeypatch.setenv(profiling.ENV, str(out))
    guard.at_step = 2
    res = run(tmp_path / "exp")
    assert res.preempted and res.step == 2
    (path,) = traces(out)
    data, n = annotations(path)  # a whole JSON document: the window was closed
    assert n == 1 and data[profiling.STEPS_KEY] == "1"


# ---------------------------------------------------------------------------
# the meters and the batch line
# ---------------------------------------------------------------------------

class Clock:
    """time.time for the meters: each call a quarter of a second later."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def test_step_timer_summary_matches_jax(monkeypatch):
    summaries = []
    for timer in (profiling.StepTimer, jprofiling.StepTimer):
        clock = iter([0.0, 0.1, 0.35, 0.5, 0.9, 1.6])
        monkeypatch.setattr(time, "time", lambda: next(clock))
        t = timer()
        for _ in range(2):
            t.data_loaded()
            t.step_done()
        t.data_loaded()
        summaries.append(t.summary())
    assert summaries == ["BatchTime=0.450s DataTime=0.317s"] * 2


class Fetch:
    """A step's loss that records, when it is fetched to the host, how many
    steps had been taken."""

    def __init__(self, loss, taken, fetched):
        self.loss, self.taken, self.fetched = loss, taken, fetched

    def __float__(self):
        self.fetched.append(len(self.taken))
        return float(self.loss)


def test_run_net_batch_line_at_jax_cadence(monkeypatch, tmp_path, capsys):
    """With the cadence at every 2nd batch, 5 steps print batches 1, 3 and 5
    in JAX's format (``runner_pretrain.py:364-372``): the StepTimer's mean
    under a clock that moves 0.25 s a call (0.5 s a step), the running mean
    of the epoch's losses, the lr after the step; the losses are fetched only
    at those batches."""
    monkeypatch.delenv(profiling.ENV, raising=False)
    monkeypatch.setattr(runner, "LOG_EVERY", 2)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time=Clock()))
    taken, fetched, losses, lrs = [], [], [], []
    step = runner.pretrain_step

    def counted(model, optimizer, schedule, pts, i, *a):
        loss = step(model, optimizer, schedule, pts, i, *a)
        taken.append(i)
        losses.append(float(loss))
        lrs.append(schedule(i + 1))
        return Fetch(loss, taken, fetched)
    monkeypatch.setattr(runner, "pretrain_step", counted)
    res = runner.run_net(run_cfg(), device="cpu", epochs=1, max_steps=5,
                         experiment_path=str(tmp_path))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch 0][")]
    meters, want, seen = JAverageMeter(["Loss"]), [], 0
    for idx in (0, 2, 4):
        for x in losses[seen:idx + 1]:
            meters.update([x])
        seen = idx + 1
        want.append(f"[Epoch 0][Batch {idx + 1}/128] BatchTime={0.5:.3f}s "
                    f"Loss={meters.avg(0):.4f} lr={lrs[idx]:.6f}")
    assert lines == want
    assert fetched == [1, 3, 3, 5, 5]  # at batches 1, 3 and 5 only
    assert res.epoch_loss[0] == pytest.approx(np.mean(losses), rel=1e-12)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def write_trace(path, steps=2):
    """A Kineto-format trace: ops (cpu_op, and a record_function range inside
    an autograd op) with External ids, the host calls that launched device
    events (correlation ids) and those events; a kernel whose launch is not
    in the trace (its External id names its op), a memcpy launched outside
    any op, a kernel of no op, a spin kernel and a device-side annotation
    (neither counted)."""
    def host(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts,
                "dur": dur, "args": args}

    def launch(ts, corr, cat="cuda_runtime"):
        return host(cat, "cudaLaunchKernel", ts, 0.5, correlation=corr)

    def device(name, dur, corr=None, ext=None, cat="kernel"):
        args = {"device": 0}
        args.update({} if corr is None else {"correlation": corr})
        args.update({} if ext is None else {"External id": ext})
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 100.0,
                "dur": dur, "args": args}
    events = [
        host("cpu_op", "aten::mm", 10.0, 5.0, **{"External id": 1}), launch(11.0, 201),
        launch(12.0, 202),
        host("cpu_op", "aten::add", 20.0, 5.0, **{"External id": 2}), launch(21.0, 203),
        host("cpu_op", "RowGatherBackward", 30.0, 10.0, **{"External id": 3}),
        host("user_annotation", "act_tpu_torch::row_gather_bwd", 31.0, 5.0,
             **{"External id": 4}), launch(32.0, 204, "cuda_driver"),
        host("cpu_op", "aten::mm", 40.0, 5.0, **{"External id": 5}), launch(41.0, 205),
        host("cpu_op", "aten::copy_", 50.0, 5.0, **{"External id": 6}),
        launch(90.0, 206), launch(95.0, 207),
        device("sgemm_a", 10.0, 201, 1), device("sgemm_b", 3.0, 202, 1),
        device("elementwise_add", 5.0, 203, 2), device("sum_kernel", 7.0, 204, 3),
        device("sgemm_a", 12.5, 205, 5), device("late", 4.0, 299, 2),
        device("Memcpy HtoD", 2.0, 206, cat="gpu_memcpy"), device("orphan", 1.0),
        device("spin_kernel(long)", 500.0, 207),
        device(ADAMW, 100.0, ext=1, cat="gpu_user_annotation"),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 201}]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, profiling.STEPS_KEY: str(steps)}, f)


HLO = ["# hlo_stats: device kernels, device ms: 7 of 7 rows, sorted by self time",
       "name\tcalls\tself ms\tms a step\tshare",
       "sgemm_a\t2\t0.022500\t0.011250\t0.5056",
       "sum_kernel\t1\t0.007000\t0.003500\t0.1573",
       "elementwise_add\t1\t0.005000\t0.002500\t0.1124",
       "late\t1\t0.004000\t0.002000\t0.0899",
       "sgemm_b\t1\t0.003000\t0.001500\t0.0674",
       "Memcpy HtoD\t1\t0.002000\t0.001000\t0.0449",
       "orphan\t1\t0.001000\t0.000500\t0.0225",
       "# window: 0.044500 ms over 2 steps, 0.022250 ms a step, 8 calls"]
# each kernel to the innermost op or range around its launch: the row gather's
# to its range (its External id names the autograd op around the range), the
# late kernel to its External id's op
FRAMEWORK = ["# framework_op_stats: torch ops, device ms of the kernels each launched: "
             "4 of 4 rows, sorted by self time",
             "name\tcalls\tself ms\tms a step\tshare",
             "aten::mm\t2\t0.025500\t0.012750\t0.5730",
             "aten::add\t1\t0.009000\t0.004500\t0.2022",
             "act_tpu_torch::row_gather_bwd\t1\t0.007000\t0.003500\t0.1573",
             "(no op)\t2\t0.003000\t0.001500\t0.0674",
             "# window: 0.044500 ms over 2 steps, 0.022250 ms a step, 6 calls"]


def test_report_of_a_written_trace(tmp_path):
    path = str(tmp_path / f"w{profiling.TRACE_SUFFIX}")
    write_trace(path)
    assert profile_step.report(path, "hlo_stats").splitlines() == HLO
    assert profile_step.report(path, "framework_op_stats").splitlines() == FRAMEWORK
    top = profile_step.report(path, "hlo_stats", top=2).splitlines()
    assert top == [HLO[0].replace("7 of 7", "2 of 7")] + HLO[1:4] + HLO[-1:]
    top = profile_step.report(path, "framework_op_stats", top=1).splitlines()
    assert top == [FRAMEWORK[0].replace("4 of 4", "1 of 4")] + FRAMEWORK[1:3] + FRAMEWORK[-1:]
    with pytest.raises(ValueError):
        profile_step.report(path, "op_profile")


def test_cpu_capture_of_the_pretrain_step(monkeypatch, tmp_path, capsys):
    """``python -m act_tpu_torch.profile_step --device cpu`` on the tiny
    distillation model: the framework table's rows (self host ms) sorted,
    largest first; the kernel table of the same trace empty, and it says so."""
    monkeypatch.setitem(profile_step.WORKLOADS, "pretrain", functools.partial(
        profile_step.setup_pretrain, config=run_cfg(), B=4))
    for k in ("PROFILE_TOOL", "PROFILE_REPORT_ONLY", "PROFILE_WORKLOAD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PROFILE_TOP", "12")
    profile_step.main(["--device", "cpu"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    lines = lines[next(i for i, ln in enumerate(lines) if ln.startswith("# framework")):]
    assert f"# trace: {tmp_path}" in out.err
    assert lines[0] == ("# framework_op_stats: torch ops, self host ms (no device kernel in "
                        "the window): 12 of " + lines[0].split(" of ")[-1])
    rows = [ln.split("\t") for ln in lines[2:-1]]
    ms = [float(r[2]) for r in rows]
    assert len(rows) == 12 and ms == sorted(ms, reverse=True) and ms[-1] > 0
    assert re.fullmatch(r"# window: [0-9.]+ ms over 3 steps, [0-9.]+ ms a step, \d+ calls",
                        lines[-1])
    (path,) = traces(tmp_path)
    assert annotations(path)[1] == 3
    monkeypatch.setenv("PROFILE_REPORT_ONLY", "1")
    monkeypatch.setenv("PROFILE_TOOL", "hlo_stats")
    profile_step.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip() == (
        "# hlo_stats: no device kernel in the window (a CPU capture: the profiler records "
        "device time only on a card)")


# ---------------------------------------------------------------------------
# the six workloads at smoke width
# ---------------------------------------------------------------------------

SMOKE = {
    "pretrain": lambda: dict(config=run_cfg(), B=4),
    "pointbert": lambda: dict(config=run_cfg(), B=4),
    "dvae": lambda: dict(config=smoke_cfg(VIT_CFG)),
    "finetune": lambda: dict(config=small_run_cfg(), N=256),
    "partseg": lambda: dict(B=2, N=256, G=16, widths=WIDTHS),
    "semseg": lambda: dict(B=2, N=256, G=16, widths=WIDTHS),
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_setup_builders_take_a_finite_step(name):
    wl = profile_step.WORKLOADS[name](device="cpu", **SMOKE[name]())
    pts = wl.batch(0)
    assert pts.shape[0] == wl.B and pts.device.type == "cpu"
    loss = wl.step(0, pts)
    assert loss.dim() == 0 and torch.isfinite(loss)
