"""Profile a train step on the card and print its device time by framework op
or by device kernel.

The port's counterpart of ``tools/profile_step.py``:

  python -m act_tpu_torch.profile_step                  # framework_op_stats, top 40 rows
  PROFILE_TOOL=hlo_stats python -m act_tpu_torch.profile_step
  PROFILE_WORKLOAD=dvae PROFILE_TOP=20 python -m act_tpu_torch.profile_step
  PROFILE_REPORT_ONLY=1 PROFILE_DIR=dir python -m act_tpu_torch.profile_step

``PROFILE_WORKLOAD`` picks the step: ``pretrain`` (the default), ``pointbert``,
``dvae``, ``finetune``, ``partseg`` or ``semseg``, each built by its
``setup_<workload>()`` at ``tools/bench_suite.py``'s shapes from the port's
runners (seeded weights, random clouds on the device). The capture takes two
warm steps, then traces ``STEPS`` steps in one ``torch.profiler`` window
(``utils/profiling.py``: on the card it opens with the spin kernels and the
pause of ``act_tpu_torch/profiling.py``) and writes one Kineto/Chrome trace
into ``PROFILE_DIR``, or into a temporary directory whose path goes to
stderr. The report is always read back from the newest trace file there
(``PROFILE_REPORT_ONLY`` reports one written earlier, by this tool or by a
``run_net`` under ``ACT_TPU_PROFILE``). ``PROFILE_TOOL`` picks the table,
``PROFILE_TOP`` its rows (40), sorted by self device time, largest first:

- ``framework_op_stats``: a row a torch op (a ``cpu_op`` or a
  ``record_function`` range of the trace). Each device kernel goes to the op
  that launched it: the innermost op or range open around its launch call
  (the host event of its ``correlation``), else the op its ``args["External
  id"]`` names; kernels of no op go on one ``(no op)`` row. ``calls`` counts
  the op's runs that launched a kernel. In a trace with no device kernel (a
  CPU capture) the rows are each op's self host time instead, and the header
  says so.
- ``hlo_stats``: a row a device kernel name, ``calls`` its launches.

Columns: name, calls, self ms in the window, ms a step, share of the window's
summed time; a last line gives the window's total and its step count. The
spin kernels that open a window are left out. JAX's K-step scan is a TPU
dispatch trick and is not ported. The card is the default device;
``--device cpu`` profiles on the CPU (host time only).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from act_tpu_torch.profiling import SENTINEL
from act_tpu_torch.utils.profiling import STEPS_KEY, TRACE_SUFFIX, close_window, open_window

PRETRAIN_CONFIG = "cfgs/pretrain/pretrain_act_distill.yaml"
AUTOENCODER_CONFIG = "cfgs/autoencoder/act_dvae_with_pretrained_transformer.yaml"
FINETUNE_CONFIG = "cfgs/finetune_classification/full/finetune_scan_hardest.yaml"
# tools/bench_suite.py's ACT_PointBERT: Point-BERT's published pretrain scale
POINTBERT_MODEL = dict(NAME="ACT_PointBERT", m=0.999, T=0.07, K=16384)
POINTBERT_TC = dict(mask_ratio=[0.25, 0.45], moco_loss=False, dvae_loss=True,
                    cutmix_loss=True)
FINETUNE_IN = 8192  # points a finetune cloud carries before its FPS resample
WARM, STEPS = 2, 3  # steps before the window, steps in it
TOOLS = ("framework_op_stats", "hlo_stats")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device time in a Kineto trace
OP_CATS = ("cpu_op", "user_annotation")  # what launches it: an op or a range
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # the host call of a launch
NO_OP = "(no op)"


@dataclass
class Workload:
    """A train step ``step(i, pts) -> loss`` (step ``i``'s draws from seed 0),
    the batch maker ``batch(i)`` (a (B, N, 3) f32 cloud batch on the device,
    from seed ``i``) and the batch size."""
    step: Callable[[int, torch.Tensor], torch.Tensor]
    batch: Callable[[int], torch.Tensor]
    B: int


def _clouds(B: int, N: int, dev: torch.device) -> Callable[[int], torch.Tensor]:
    def batch(i: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(i)
        return torch.randn(B, N, 3, generator=gen, device=dev)
    return batch


def _pretrain_workload(cfg, dev, B: int) -> Workload:
    from act_tpu_torch.datasets.transforms import scale_and_translate
    from act_tpu_torch.engine import builder, runner_pretrain
    from act_tpu_torch.engine.train_state import pretrain_step, step_rngs, steps_per_epoch
    cfg.model.dvae_config.ckpt = None  # seeded weights: no Stage-I checkpoint
    model = runner_pretrain.prepare_model(cfg, 0, dev)
    optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
    clip, m = cfg.get("grad_norm_clip", None), runner_pretrain.ema_momentum(cfg)
    return Workload(lambda i, pts: pretrain_step(model, optimizer, schedule, pts, i,
                                                 step_rngs(0, i, dev), scale_and_translate,
                                                 clip, m),
                    _clouds(B, int(cfg.dataset.train.others.npoints), dev), B)


def setup_pretrain(device="cuda", config=PRETRAIN_CONFIG, B: int = 128) -> Workload:
    """ACT_PointDistillation's step at ``pretrain_act_distill.yaml``, B=128:
    the 384 x 12 student, the frozen bf16 tokenizer with the prompted ViT-B
    teacher (64 deep prompts)."""
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.ops._backend import resolve_device
    return _pretrain_workload(load_config(config), resolve_device(device), B)


def pointbert_config(config=PRETRAIN_CONFIG):
    """``config`` (a pretrain YAML or mapping) as bench_suite's ACT_PointBERT
    (MoCo K=16384, m=0.999, mixup, the dVAE and cutmix losses), with no
    Stage-I checkpoint."""
    from act_tpu_torch.engine.serve import load_config
    cfg = load_config(config)
    cfg.model.update(POINTBERT_MODEL)
    cfg.model.transformer_config.update(POINTBERT_TC)
    cfg.model.dvae_config.ckpt = None
    return cfg


def setup_pointbert(device="cuda", config=PRETRAIN_CONFIG, B: int = 128) -> Workload:
    """ACT_PointBERT's step (``pointbert_config``) on ``config``'s model, B=128."""
    from act_tpu_torch.ops._backend import resolve_device
    return _pretrain_workload(pointbert_config(config), resolve_device(device), B)


def setup_dvae(device="cuda", config=AUTOENCODER_CONFIG) -> Workload:
    """The Stage-I dVAE's step with the prompted ViT-B teacher at the YAML's
    ``total_bs`` x ``npoints``, temperature 1, KLD weight 0."""
    from act_tpu_torch.engine import builder, runner_autoencoder
    from act_tpu_torch.engine.serve import load_config
    from act_tpu_torch.engine.train_state import autoencoder_step, step_rngs, steps_per_epoch
    from act_tpu_torch.ops._backend import resolve_device
    cfg, dev = load_config(config), resolve_device(device)
    model = runner_autoencoder.prepare_model(cfg, 0, dev)
    optimizer, schedule = builder.build_optimizer(cfg, model, steps_per_epoch(cfg))
    clip = cfg.get("grad_norm_clip", None)
    return Workload(lambda i, pts: autoencoder_step(model, optimizer, schedule, pts, i,
                                                    step_rngs(0, i, dev), 1.0, 0.0, clip)[0],
                    _clouds(int(cfg.total_bs), int(cfg.npoints), dev), int(cfg.total_bs))


def setup_finetune(device="cuda", config=FINETUNE_CONFIG, N: int = FINETUNE_IN) -> Workload:
    """The classification step at ``finetune_scan_hardest.yaml``'s
    ``total_bs``, its clouds of ``N`` points resampled by ``fps_subsample``."""
    from act_tpu_torch.engine import runner_finetune
    from act_tpu_torch.engine.train_state import steps_per_epoch
    from act_tpu_torch.ops._backend import resolve_device
    cfg, dev = runner_finetune.finetune_config(config), resolve_device(device)
    st = runner_finetune.build_state(cfg, steps_per_epoch(cfg), 0, dev)
    B = int(cfg.total_bs)
    labels = torch.zeros(B, dtype=torch.long, device=dev)
    return Workload(lambda i, pts: runner_finetune.train_step(st, pts, labels, i, 0)[0],
                    _clouds(B, N, dev), B)


def _seg_workload(task: str, device, B: int, N: int, G: int, widths) -> Workload:
    from act_tpu_torch.engine.runner_segmentation import (GRAD_NORM_CLIP, NUM_SHAPE_CATEGORIES,
                                                          S3DIS_NUM_CLASSES, build_seg_state)
    from act_tpu_torch.engine.train_state import seg_step, step_rngs
    from act_tpu_torch.ops._backend import resolve_device
    dev = resolve_device(device)
    st = build_seg_state(task, 100, num_group=G, device=dev, widths=widths)
    target = torch.zeros(B, N, dtype=torch.long, device=dev)
    one_hot = weight = None
    if task == "partseg":
        one_hot = torch.zeros(B, NUM_SHAPE_CATEGORIES, device=dev)
        one_hot[:, 0] = 1.0
    else:
        weight = torch.ones(S3DIS_NUM_CLASSES, device=dev)
    return Workload(lambda i, pts: seg_step(st.model, st.optimizer, st.schedule, pts, target,
                                            i, step_rngs(0, i, dev), one_hot, weight,
                                            GRAD_NORM_CLIP),
                    _clouds(B, N, dev), B)


def setup_partseg(device="cuda", B: int = 16, N: int = 2048, G: int = 128,
                  widths=None) -> Workload:
    """The ShapeNetPart step at the CLI defaults (B=16, 2048 points, 128
    groups), every cloud of category 0; ``widths`` narrows the backbone."""
    return _seg_workload("partseg", device, B, N, G, widths)


def setup_semseg(device="cuda", B: int = 32, N: int = 2048, G: int = 128,
                 widths=None) -> Workload:
    """The S3DIS step at the CLI defaults (B=32, 2048 points, 128 groups),
    unit class weights."""
    return _seg_workload("semseg", device, B, N, G, widths)


WORKLOADS = {"pretrain": setup_pretrain, "pointbert": setup_pointbert, "dvae": setup_dvae,
             "finetune": setup_finetune, "partseg": setup_partseg, "semseg": setup_semseg}


def capture(wl: Workload, trace_dir: str, device) -> str:
    """``WARM`` steps, then ``STEPS`` steps in one profiler window (their
    batches made before it), written to ``trace_dir``. Returns the trace's
    path."""
    for i in range(WARM):
        wl.step(i, wl.batch(i))
    batches = [wl.batch(10 + i) for i in range(STEPS)]
    prof = open_window(device)
    for i, pts in enumerate(batches):
        wl.step(WARM + i, pts)
    return close_window(prof, trace_dir, STEPS, device)


def newest_trace(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    return max(paths, key=os.path.getmtime)


# ---------------------------------------------------------------------------
# the report, read from a Kineto trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A trace's device events (name, µs, the index in ``op_events`` of the
    op that launched it or None), its op events ((pid, tid), name, start µs,
    µs) and the steps its window holds."""
    kernels: List[Tuple[str, float, Optional[int]]]
    op_events: List[Tuple[Tuple, str, float, float]]
    steps: int


def launching_ops(op_events, launches) -> Dict[int, int]:
    """correlation -> the index in ``op_events`` of the innermost op event
    open on the thread of that launch (``launches``: (thread, µs,
    correlation) of each host call that launched a device event)."""
    by_thread = defaultdict(list)
    for i, (thread, _, ts, dur) in enumerate(op_events):
        by_thread[thread].append((ts, 0, -dur, i))
    for thread, ts, corr in launches:
        by_thread[thread].append((ts, 1, 0.0, corr))
    out = {}
    for events in by_thread.values():
        stack = []  # (end, index) of the open op events, innermost last
        for ts, kind, neg, ref in sorted(events):
            while stack and ts >= stack[-1][0]:
                stack.pop()
            if kind == 0:
                stack.append((ts - neg, ref))
            elif stack:
                out[ref] = stack[-1][1]
    return out


def read_trace(path: str) -> Trace:
    """The events of the Kineto/Chrome trace at ``path``, without the spin
    kernels that open a window on the card. A device event's op is the
    innermost op or ``record_function`` range open around its launch (the
    ``cuda_runtime`` / ``cuda_driver`` event of the same ``correlation``),
    else the op its ``External id`` names: Kineto's External id is the
    innermost torch op's and never a range's (a ``record_function`` is a user
    scope), so it alone would give a wrapper's kernel to the op around the
    range, or to no op."""
    with open(path) as f:
        data = json.load(f)
    raw, op_events, launches, by_ext = [], [], [], {}
    for e in data.get("traceEvents", []):
        cat, args = e.get("cat"), e.get("args") or {}
        if e.get("ph") != "X":
            continue
        thread = (e.get("pid"), e.get("tid"))
        if cat in DEVICE_CATS and SENTINEL not in e["name"]:
            raw.append((e["name"], float(e["dur"]), args.get("correlation"),
                        args.get("External id")))
        elif cat in OP_CATS:
            if "External id" in args:
                by_ext[args["External id"]] = len(op_events)
            op_events.append((thread, e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches.append((thread, float(e["ts"]), args["correlation"]))
    launched = launching_ops(op_events, launches)
    kernels = [(name, dur, launched.get(corr, by_ext.get(ext))) for name, dur, corr, ext in raw]
    return Trace(kernels, op_events, int(data.get(STEPS_KEY, 1)))


def _rows(calls: Dict[str, int], us: Dict[str, float]) -> List[Tuple[str, int, float]]:
    """(name, calls, ms) sorted by ms, largest first, then by name."""
    return sorted(((n, calls[n], us[n] / 1e3) for n in us), key=lambda r: (-r[2], r[0]))


def kernel_rows(tr: Trace) -> List[Tuple[str, int, float]]:
    """hlo_stats: a row a device kernel name, its launches and device ms."""
    calls, us = defaultdict(int), defaultdict(float)
    for name, dur, _ in tr.kernels:
        calls[name] += 1
        us[name] += dur
    return _rows(calls, us)


def host_self_us(op_events) -> List[Tuple[str, float]]:
    """(name, self µs) of each op event: its duration less those of the
    events nested directly in it on its thread."""
    out = []
    by_thread = defaultdict(list)
    for thread, name, ts, dur in op_events:
        by_thread[thread].append((ts, -dur, name))
    for events in by_thread.values():
        stack = []  # [end, name, self] of the open events
        for ts, neg, name in sorted(events):
            while stack and ts >= stack[-1][0]:
                _, n, s = stack.pop()
                out.append((n, s))
            if stack:
                stack[-1][2] += neg
            stack.append([ts - neg, name, -neg])
        out += [(n, s) for _, n, s in stack]
    return out


def op_rows(tr: Trace) -> List[Tuple[str, int, float]]:
    """framework_op_stats: a row a torch op, the device ms of the kernels it
    launched itself and its runs that launched any (``NO_OP``: kernels of no
    op, each a call); with no device kernel in the trace, each op's self host
    ms and its runs."""
    calls, us = defaultdict(int), defaultdict(float)
    if not tr.kernels:
        for name, self_us in host_self_us(tr.op_events):
            calls[name] += 1
            us[name] += self_us
        return _rows(calls, us)
    seen = set()
    for _, dur, i in tr.kernels:
        name = NO_OP if i is None else tr.op_events[i][1]
        us[name] += dur
        if i is None or i not in seen:
            calls[name] += 1
        seen.add(i)
    return _rows(calls, us)


def table(rows: List[Tuple[str, int, float]], steps: int, top: int, what: str) -> List[str]:
    """The lines of a table: a header, the first ``top`` rows (tab-separated:
    name, calls, ms in the window, ms a step, share of the window's total)
    and the total line."""
    total = sum(r[2] for r in rows)
    lines = [f"# {what}: {min(top, len(rows))} of {len(rows)} rows, sorted by self time",
             "name\tcalls\tself ms\tms a step\tshare"]
    lines += [f"{n}\t{c}\t{ms:.6f}\t{ms / steps:.6f}\t{ms / total:.4f}"
              for n, c, ms in rows[:top]]
    lines.append(f"# window: {total:.6f} ms over {steps} steps, {total / steps:.6f} ms a step, "
                 f"{sum(r[1] for r in rows)} calls")
    return lines


def report(path: str, tool: str = "framework_op_stats", top: int = 40) -> str:
    """The ``tool`` table of the trace at ``path``, its first ``top`` rows."""
    if tool not in TOOLS:
        raise ValueError(f"PROFILE_TOOL must be one of {TOOLS}, got {tool!r}")
    tr = read_trace(path)
    if tool == "hlo_stats":
        if not tr.kernels:
            return ("# hlo_stats: no device kernel in the window (a CPU capture: the "
                    "profiler records device time only on a card)")
        return "\n".join(table(kernel_rows(tr), tr.steps, top, "hlo_stats: device kernels, "
                                                                 "device ms"))
    what = ("framework_op_stats: torch ops, device ms of the kernels each launched" if tr.kernels
            else "framework_op_stats: torch ops, self host ms (no device kernel in the window)")
    return "\n".join(table(op_rows(tr), tr.steps, top, what))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tool = os.environ.get("PROFILE_TOOL", "framework_op_stats")
    top = int(os.environ.get("PROFILE_TOP", "40"))
    if tool not in TOOLS:
        raise SystemExit(f"unknown PROFILE_TOOL {tool!r}; valid: {list(TOOLS)}")
    trace_dir = os.environ.get("PROFILE_DIR") or tempfile.mkdtemp(prefix="act_tpu_torch_prof_")
    if not os.environ.get("PROFILE_REPORT_ONLY"):
        name = os.environ.get("PROFILE_WORKLOAD", "pretrain")
        if name not in WORKLOADS:
            raise SystemExit(f"unknown PROFILE_WORKLOAD {name!r}; valid: {sorted(WORKLOADS)}")
        capture(WORKLOADS[name](args.device), trace_dir, torch.device(args.device))
    print(f"# trace: {trace_dir}", file=sys.stderr)
    print(report(newest_trace(trace_dir), tool, top))


if __name__ == "__main__":
    main()
