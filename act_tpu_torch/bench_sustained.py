"""Sustained, loader-fed Stage-II pretraining: can the host feed the card?
(counterpart of ``tools/bench_sustained.py``).

  python -m act_tpu_torch.bench_sustained                  # 8192 clouds, workers 0 and 8
  python -m act_tpu_torch.bench_sustained --files 2048 --num_workers 0,8 --epochs 3
  python -m act_tpu_torch.bench_sustained --skip_e2e       # the loader alone

``act_tpu_torch.bench`` times the step on batches already on the card. This
tool (1) writes a synthetic ShapeNet-55 tree (``build_tree``: ``train.txt``,
``test.txt`` and one (8192, 3) ``.npy`` a cloud under ``shapenet_pc``, the
reference's layout, with the JAX tool's names and draws), (2) times the
port's loader alone on it (``bench_loader``: the ``.npy`` reads, the
subsample, the normalisation and the collation of ``datasets/``, the
``ShapeNet`` dataset refusing its synthetic fallback) at each
``--num_workers`` (0 and 8 by default), and (3) runs Stage II's
``runner_pretrain.run_net`` at ``pretrain_act_distill.yaml`` over the tree
(``bench_e2e``: a random tokenizer, no ``val`` or ``extra_train`` splits,
the last ``--num_workers`` value's workers) for ``--epochs`` epochs. Its
rate is the clouds of an epoch, ``(n_total // B) * B`` with the split's
``whole`` flag as the loader counts them, over the steadiest epoch after
the first (run_net's ``EpochTime``; the first carries the kernels' loading
and the allocator's warm-up). Each rate is printed with the device, and the
record goes to ``build/bench/sustained_last.json`` (``RECORD``), which
``act_tpu_torch.bench_suite`` reads; each run writes it anew, so that its
legs, time, file count and device are one run's (the JAX tool merges a run
into the previous record).

The tree goes to ``--root`` (default under the system's temporary
directory) and is reused while its marker is there. ``run_net`` runs on the
card unless ``--device cpu`` is given. Not ported, being TPU workarounds:
``--scan_steps``, ``--ckpt_every`` and ``--h2d_dtype``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from act_tpu_torch.utils.config import ConfigDict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "build", "bench", "sustained_last.json")
PRETRAIN_CONFIG = "cfgs/pretrain/pretrain_act_distill.yaml"
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "act_tpu_torch_shapenet_synth")


def build_tree(root: str, n_files: int, n_points: int = 8192) -> None:
    """ShapeNet-55's layout under ``root``: ``train.txt`` (every file),
    ``test.txt`` (the first 128) and ``shapenet_pc/<taxonomy>-synth<i>.npy``,
    (n_points, 3) f32 normal draws of ``default_rng(0)`` in file order;
    reused while the marker ``.complete_<n_files>_<n_points>`` is there."""
    pc_path = os.path.join(root, "shapenet_pc")
    os.makedirs(pc_path, exist_ok=True)
    marker = os.path.join(root, f".complete_{n_files}_{n_points}")
    if os.path.exists(marker):
        print(f"# reusing synthetic tree at {root} ({n_files} files)")
        return
    print(f"# generating {n_files} x ({n_points}, 3) .npy under {root} ...")
    rng = np.random.default_rng(0)
    t0 = time.time()
    lines = []
    for i in range(n_files):
        tax = f"{i % 55:08d}"
        name = f"{tax}-synth{i:06d}.npy"
        np.save(os.path.join(pc_path, name),
                rng.standard_normal((n_points, 3), dtype=np.float32))
        lines.append(name)
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines if split == "train" else lines[:128]))
    with open(marker, "w") as f:
        f.write("ok")
    print(f"# tree built in {time.time() - t0:.1f}s")


def shapenet(root: str, npoints: int, subset: str = "train", whole: bool = False):
    """The port's ShapeNet-55 dataset on the tree at ``root``; raises if the
    tree is not there (the dataset would fall back to synthetic clouds)."""
    from act_tpu_torch.datasets.pointcloud_datasets import ShapeNet
    ds = ShapeNet(ConfigDict(dict(NAME="ShapeNet", N_POINTS=8192, DATA_PATH=root,
                                  PC_PATH=os.path.join(root, "shapenet_pc"), subset=subset,
                                  whole=whole, npoints=npoints)))
    if ds.synthetic:
        raise FileNotFoundError(f"no ShapeNet-55 tree at {root}: the loader fell back to "
                                "synthetic clouds")
    return ds


def loader(root: str, batch_size: int, npoints: int, num_workers: int):
    """The trainers' loader on the tree: shuffled from seed 0, no last
    partial batch, 2 batches ahead, ``num_workers`` forked workers."""
    from act_tpu_torch.datasets import DataLoader
    return DataLoader(shapenet(root, npoints), batch_size, shuffle=True, drop_last=True, seed=0,
                      prefetch=2, num_workers=num_workers)


def bench_loader(root: str, batch_size: int, npoints: int, n_batches: int,
                 num_workers: int) -> float:
    """Clouds/s of the loader alone over ``n_batches`` batches, after one
    batch outside the clock (the pool's start, the page cache)."""
    dl = loader(root, batch_size, npoints, num_workers)
    try:
        it = iter(dl)
        next(it)
        t0, n = time.time(), 0
        for _ in range(n_batches):
            try:
                batch = next(it)
            except StopIteration:
                break
            n += len(batch[2])
        return n / (time.time() - t0)
    finally:
        dl.close()


def clouds_per_epoch(cfg) -> int:
    """The clouds of a Stage-II epoch of ``cfg``'s train split: its dataset's
    length with the split's ``whole`` flag, in whole batches of ``total_bs``."""
    base, others = cfg.dataset.train._base_, cfg.dataset.train.others
    B = int(cfg.total_bs)
    n = len(shapenet(base.DATA_PATH, int(others.npoints), others.get("subset", "train"),
                     bool(others.get("whole", False))))
    return (n // B) * B


def e2e_config(root: str, epochs: int):
    """``pretrain_act_distill.yaml`` over the tree at ``root``, ``epochs``
    (at least 2) epochs, without the probe's splits."""
    from act_tpu_torch.engine.serve import load_config
    cfg = load_config(PRETRAIN_CONFIG)
    cfg.max_epoch = max(int(epochs), 2)
    for split in cfg.dataset.values():
        if "_base_" in split:
            split._base_.DATA_PATH = root
            split._base_.PC_PATH = os.path.join(root, "shapenet_pc")
    cfg.dataset.pop("val", None)
    cfg.dataset.pop("extra_train", None)
    return cfg


class EpochTimes(logging.Handler):
    """Collects the ``EpochTime=`` seconds of run_net's epoch lines."""

    def __init__(self):
        super().__init__()
        self.seconds: List[float] = []

    def emit(self, record: logging.LogRecord) -> None:
        m = re.search(r"EpochTime=([\d.]+)s", record.getMessage())
        if m:
            self.seconds.append(float(m.group(1)))


def bench_e2e(cfg, num_workers: int, device="cuda") -> Dict:
    """``run_net`` of ``cfg`` (``e2e_config``) for its ``max_epoch`` epochs;
    returns the clouds, the wall seconds, each epoch's seconds and the
    clouds/s of the steadiest epoch after the first."""
    from act_tpu_torch.engine import runner_pretrain
    epochs = int(cfg.max_epoch)
    per_epoch = clouds_per_epoch(cfg)
    times = EpochTimes()
    logger = logging.getLogger(f"{__name__}.e2e")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handlers = [times, logging.StreamHandler(sys.stdout)]
    for h in handlers:
        logger.addHandler(h)
    exp = tempfile.mkdtemp(prefix="act_tpu_torch_sustained_")
    try:
        t0 = time.time()
        runner_pretrain.run_net(cfg, device=device, epochs=epochs, experiment_path=exp,
                                allow_random_tokenizer=True, num_workers=num_workers,
                                logger=logger)
        wall = time.time() - t0
    finally:
        for h in handlers:
            logger.removeHandler(h)
        shutil.rmtree(exp, ignore_errors=True)
    steady = min(times.seconds[1:])
    return {"clouds": per_epoch * epochs, "wall_s": wall, "epoch_times_s": times.seconds,
            "clouds_per_sec": per_epoch / steady}


def main(argv: Optional[List[str]] = None) -> None:
    from act_tpu_torch.bench import device_record
    from act_tpu_torch.ops import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--files", type=int, default=8192,
                    help="synthetic clouds in the tree (ShapeNet-55 train has 41952; 8192 "
                         "gives the same costs a cloud)")
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--loader_batches", type=int, default=40)
    ap.add_argument("--num_workers", default="0,8",
                    help="comma-separated worker counts of the loader legs; the e2e leg "
                         "takes the last")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--skip_e2e", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = device_record(dev)
    label = where["card"] or where["device"]["name"]
    workers = [int(w) for w in args.num_workers.split(",")]
    build_tree(args.root, args.files)
    rec: Dict = dict(files=args.files, batch=args.batch_size, loader={}, **where)
    for w in workers:
        rate = bench_loader(args.root, args.batch_size, args.npoints, args.loader_batches, w)
        rec["loader"][str(w)] = rate
        print(f"loader-only: {rate:,.1f} clouds/sec (bs={args.batch_size}, workers={w}; the "
              f"host of {label})", flush=True)
    if not args.skip_e2e:
        e2e = bench_e2e(e2e_config(args.root, args.epochs), workers[-1], dev)
        rec.update(e2e=e2e["clouds_per_sec"], e2e_workers=workers[-1],
                   epoch_times_s=e2e["epoch_times_s"])
        print(f"end-to-end sustained: {e2e['clouds_per_sec']:,.1f} clouds/sec on {label} "
              f"({e2e['clouds']} clouds in {e2e['wall_s']:.1f}s, epochs "
              f"{e2e['epoch_times_s']} s, workers={workers[-1]})", flush=True)
    rec["ts"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
