"""Finetune steps on one CUDA card fed by the loader built three ways: on its
prefetch thread, in process between steps, and by forked workers.

  python -m act_tpu_torch.loader_sweep [--steps 8] [--clouds 256] [--workers 8] [--out FILE]

The full-width ModelNet40 finetune step (``finetune_modelnet.yaml``, B=32)
takes ``--steps`` steps from one loader after another, in turns: batches
built on the loader's prefetch thread while the step runs, built in this
process between steps, and built by ``--workers`` forked workers, twice
each (thread, in process, workers, workers, in process, thread), on two
datasets: the synthetic ModelNet40 fallback, and a ModelNet40 tree of the
real layout held in memory (its offline FPS cache, ``--clouds`` clouds of
8192 points with normals drawn from a seed, written to a temporary
directory and deleted afterwards). Prints each run's host median ms a step
(the step alone) and its wall ms a step (the median time between two
batches handed to the step, the loader's wait included), the first step of
a run left out, and each dataset's clouds/s built in process without a
step, and writes the rows as JSON to ``--out`` (default
``chiprun_out/loader_sweep.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np

from act_tpu_torch.datasets import DataLoader, build_dataset_from_cfg
from act_tpu_torch.engine import runner_finetune
from act_tpu_torch.ops import _backend
from act_tpu_torch.profiling import card_line
from act_tpu_torch.utils.config import ConfigDict

CONFIG = "cfgs/finetune_classification/full/finetune_modelnet.yaml"


def write_modelnet(root: str, clouds: int, n_points: int, seed: int = 0) -> None:
    """A ModelNet40 tree under ``root`` that the dataset reads from its
    offline FPS cache alone: the shape names, the train list and
    ``modelnet40_train_{n_points}pts_fps.dat`` with ``clouds`` clouds of
    (n_points, 6) f32 and their labels, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    names = [f"class{c:02d}" for c in range(40)]
    ids = [f"{names[i % 40]}_{i:04d}" for i in range(clouds)]
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("".join(n + "\n" for n in names))
    with open(os.path.join(root, "modelnet40_train.txt"), "w") as f:
        f.write("".join(i + "\n" for i in ids))
    points = [rng.normal(size=(n_points, 6)).astype(np.float32) for _ in range(clouds)]
    labels = [np.array([i % 40], dtype=np.int32) for i in range(clouds)]
    with open(os.path.join(root, f"modelnet40_train_{n_points}pts_fps.dat"), "wb") as f:
        pickle.dump((points, labels), f)


def clouds_per_s(dataset, batch: int, batches: int = 4) -> float:
    """Clouds a second that the loader builds in process, with no step."""
    loader = DataLoader(dataset, batch, shuffle=True, drop_last=True, prefetch=0)
    t0 = time.perf_counter()
    n = sum(len(b[2][1]) for _, b in zip(range(batches), loader))  # (points, labels)
    return n / (time.perf_counter() - t0)


def handed(batches, marks):
    """``batches``, with the time each one is handed on appended to ``marks``."""
    for b in batches:
        marks.append(time.perf_counter())
        yield b


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8, help="finetune steps a run")
    ap.add_argument("--clouds", type=int, default=256, help="clouds of the in-memory tree")
    ap.add_argument("--workers", type=int, default=8, help="forked workers of the pool runs")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/loader_sweep.json"))
    args = ap.parse_args()
    dev = _backend.resolve_device("cuda")
    _backend.build_kernels()
    card = card_line()
    print(f"card: {card}", flush=True)
    cfg = runner_finetune.finetune_config(CONFIG)
    (train_loader,) = runner_finetune.loaders(cfg, 0, ("train",))
    bs = train_loader.batch_size
    n_points = int(cfg.dataset.train._base_.N_POINTS)
    tmp = tempfile.mkdtemp(prefix="loader_sweep_")
    rows = []
    try:
        write_modelnet(tmp, args.clouds, n_points)
        real = build_dataset_from_cfg(ConfigDict(
            {"_base_": {**cfg.dataset.train._base_, "DATA_PATH": tmp},
             "others": {"subset": "train"}}))
        assert not getattr(real, "synthetic", False)
        st = runner_finetune.build_state(cfg, 1, 0, dev)
        step = 0
        for name, dataset in (("synthetic", train_loader.dataset),
                              (f"in-memory ModelNet40 tree, {args.clouds} clouds", real)):
            rate = clouds_per_s(dataset, bs)
            kinds = ("thread", "in process", "workers")
            medians, walls = {k: [] for k in kinds}, {k: [] for k in kinds}
            for kind in kinds + kinds[::-1]:
                loader = DataLoader(dataset, bs, shuffle=True, drop_last=True, seed=step,
                                    prefetch=0 if kind == "in process" else 2,
                                    num_workers=args.workers if kind == "workers" else 0)
                marks = []
                try:
                    run = runner_finetune.run_finetune_steps(
                        CONFIG, args.steps, batches=handed(loader, marks), device=dev,
                        state=st, start_step=step)
                finally:
                    loader.close()
                step += args.steps
                medians[kind].append(statistics.median(run.step_ms[1:]))
                walls[kind].append(statistics.median(np.diff(marks)[1:]) * 1e3)
            rows.append({"dataset": name, "batch": bs, "steps": args.steps,
                         "workers": args.workers, "clouds_per_s_in_process": rate,
                         "median_ms": medians, "wall_ms": walls, "card": card})
            built = {"thread": "on the prefetch thread", "in process": "in process",
                     "workers": f"by {args.workers} workers"}
            for kind in kinds:
                print(f"[time] finetune step B={bs}, {name}, batches built {built[kind]}: "
                      f"host median over {args.steps - 1} steps {medians[kind]} ms, wall a "
                      f"step {[float(w) for w in walls[kind]]} ms", flush=True)
            print(f"[time] loader alone, {name}: {rate:.1f} clouds/s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
