"""The point-cloud datasets: ShapeNet-55, ModelNet40, its few-shot splits and
ScanObjectNN.

Counterpart of ``act_tpu/datasets/pointcloud_datasets.py:36-322`` (reference
datasets/ShapeNet55Dataset.py, ModelNetDataset.py, ModelNetDatasetFewShot.py,
ScanObjectNNDataset.py). ShapeNet returns ``(taxonomy_id, model_id, points)``,
the classification classes ``(taxonomy_id, model_id, (points, label))``, all
numpy. When the configured data is
missing, a class serves the JAX package's deterministic synthetic clouds
(``datasets/synthetic.py``): the same samples, labels and train-time point
shuffles, bit for bit. ``h5py`` is imported only to read a real ScanObjectNN
archive.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np

from act_tpu_torch.datasets.build import DATASETS
from act_tpu_torch.datasets.io import IO
from act_tpu_torch.datasets.loader import default_collate
from act_tpu_torch.datasets.synthetic import synthetic_cloud
from act_tpu_torch.utils.misc import pc_normalize


def shuffle_rows(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """``pts`` with its rows in the order that ``rng.shuffle(pts)`` leaves
    them, from the same draws (the rng ends in the same state):
    ``Generator.permutation(n)`` runs the same Fisher-Yates draws on an index
    vector in compiled code, where ``shuffle`` of a 2-D array swaps its rows
    one at a time through numpy indexing, which costs more than the rest of
    an item at 8192 points."""
    return pts[rng.permutation(len(pts))]


def farthest_point_sample_np(point: np.ndarray, npoint: int) -> np.ndarray:
    """Host FPS of one (N, D) cloud on its first three columns, from index 0
    (reference ModelNetDataset.py:29-50): the plain loop that the tests hold
    the cache's picks to. The cache itself goes through :func:`fps_cache`."""
    xyz = point[:, :3]
    centroids = np.zeros((npoint,), dtype=np.int64)
    distance = np.full((point.shape[0],), np.inf)
    farthest = 0
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest, :]) ** 2, -1)
        distance = np.minimum(distance, dist)
        farthest = int(np.argmax(distance))
    return point[centroids]


CACHE_BATCH = 64  # clouds of one FPS launch while the ModelNet cache is built


def fps_cache(paths, npoints: int, device="cuda", batch: int = CACHE_BATCH):
    """The offline FPS cache's clouds: each ``.txt`` of ``paths`` parsed as
    the JAX dataset parses it (``np.loadtxt(path, delimiter=',')`` in f64,
    then f32), and its ``npoints`` rows at the FPS picks on the first three
    columns (``native.fps`` on ``device``: the card's FPS kernel, one launch
    for up to ``batch`` clouds of one point count, in file order). Returns
    (the (npoints, C) f32 clouds in file order, the parse's host seconds,
    the FPS's host seconds with the transfers). The parse runs in this
    process: ``np.loadtxt`` holds the interpreter lock, so threads do not
    help, and forked parsers of a multi-threaded trainer (or test) process
    can deadlock."""
    from act_tpu_torch import native  # torch, only when a cache is built
    out, parse_s, fps_s = [], 0.0, 0.0
    for lo in range(0, len(paths), batch):
        t0 = time.perf_counter()
        clouds = [np.loadtxt(p, delimiter=",").astype(np.float32) for p in paths[lo:lo + batch]]
        parse_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        picked = [None] * len(clouds)
        for shape in dict.fromkeys(c.shape for c in clouds):
            members = [i for i, c in enumerate(clouds) if c.shape == shape]
            idx = native.fps(np.stack([clouds[i][:, :3] for i in members]), npoints, device)
            for i, ix in zip(members, idx):
                picked[i] = clouds[i][ix]
        fps_s += time.perf_counter() - t0
        out += picked
    return out, parse_s, fps_s


class _SyntheticMixin:
    """Fallback sample generation when the real data is absent."""
    synthetic: bool = False
    synthetic_len: int = 512

    def _maybe_synthetic(self, path: str, name: str) -> bool:
        if path and os.path.exists(path):
            return False
        print(f"[DATASET] {name}: '{path}' not found, serving deterministic synthetic "
              f"clouds ({self.synthetic_len} samples)", flush=True)
        self.synthetic = True
        return True


@DATASETS.register_module()
class ShapeNet(_SyntheticMixin):
    """ShapeNet-55 clouds from ``{DATA_PATH}/{subset}.txt`` (``whole`` puts
    ``test.txt``'s lines first), each ``N_POINTS`` points read from
    ``PC_PATH``, subsampled to ``npoints`` without replacement and
    normalised into the unit sphere. Without ``PC_PATH`` it serves 512
    synthetic clouds of ``N_POINTS`` points, taxonomy ``i % 55``."""
    NUM_CLASSES = 55

    def __init__(self, config):
        self.data_root = config.DATA_PATH
        self.pc_path = config.get("PC_PATH", "")
        self.subset = config.subset
        self.npoints = config.N_POINTS
        self.sample_points_num = config.npoints
        self.whole = bool(config.get("whole", False))
        self.rng = np.random.default_rng(0)
        if self._maybe_synthetic(self.pc_path, "ShapeNet-55"):
            self.file_list = [{"taxonomy_id": f"{i % self.NUM_CLASSES:08d}",
                               "model_id": f"synthetic_{i}", "file_path": None}
                              for i in range(self.synthetic_len)]
            return
        with open(os.path.join(self.data_root, f"{self.subset}.txt")) as f:
            lines = f.readlines()
        if self.whole:
            with open(os.path.join(self.data_root, "test.txt")) as f:
                lines = f.readlines() + lines
        self.file_list = []
        for line in lines:
            line = line.strip()
            self.file_list.append({"taxonomy_id": line.split("-")[0],
                                   "model_id": line.split("-")[1].split(".")[0],
                                   "file_path": line})
        print(f"[DATASET] ShapeNet-55: {len(self.file_list)} instances loaded", flush=True)

    def random_sample(self, pc: np.ndarray, num: int) -> np.ndarray:
        """``num`` points of ``pc`` drawn without replacement."""
        return pc[self.rng.choice(pc.shape[0], num, replace=False)]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        sample = self.file_list[idx]
        if self.synthetic:
            pts, _ = synthetic_cloud(idx, self.npoints, self.NUM_CLASSES)
        else:
            pts = IO.get(os.path.join(self.pc_path, sample["file_path"])).astype(np.float32)
        pts = pc_normalize(self.random_sample(pts, self.sample_points_num)).astype(np.float32)
        return sample["taxonomy_id"], sample["model_id"], pts

    def get_batch(self, idxs):
        """The loader's batch of ``idxs``: what collating ``self[i]`` gives,
        with the same draws in the same order, but the subsample and the
        normalisation done once over the (B, N, 3) stack when every file has
        the same point count (``pointcloud_datasets.py:132-176``)."""
        if self.synthetic:
            return default_collate([self[int(i)] for i in idxs])
        samples = [self.file_list[int(i)] for i in idxs]
        tax = [s["taxonomy_id"] for s in samples]
        mid = [s["model_id"] for s in samples]
        clouds = [IO.get(os.path.join(self.pc_path, s["file_path"])) for s in samples]
        if len({c.shape for c in clouds}) > 1:
            return tax, mid, np.stack([
                pc_normalize(self.random_sample(c.astype(np.float32),
                                                self.sample_points_num)).astype(np.float32)
                for c in clouds])
        stack = np.stack(clouds).astype(np.float32, copy=False)
        B, N = stack.shape[:2]
        sel = np.stack([self.rng.choice(N, self.sample_points_num, replace=False)
                        for _ in range(B)])
        pts = np.take_along_axis(stack, sel[..., None], axis=1)
        pts = pts - pts.mean(axis=1, keepdims=True)
        m = np.sqrt(np.einsum("bij,bij->bi", pts, pts).max(axis=1))
        pts = pts / np.maximum(m, 1e-12)[:, None, None]
        return tax, mid, pts.astype(np.float32, copy=False)


@DATASETS.register_module()
class ShapeNetImagePoint(ShapeNet):
    """ShapeNet registered under a second name (the reference keeps an
    identical second class)."""


@DATASETS.register_module()
class ModelNet(_SyntheticMixin):
    """ModelNet40 clouds from ``modelnet40_normal_resampled``
    (``{DATA_PATH}/modelnet40_{subset}.txt``), ``N_POINTS`` of each taken by
    FPS once and kept in the offline cache
    ``modelnet{NUM_CATEGORY}_{subset}_{N_POINTS}pts_fps.dat`` beside them: the
    JAX dataset's file (``pointcloud_datasets.py:211-228``), which either
    package reads and writes, ``pickle.dump((points, labels))`` of (N_POINTS,
    6) f32 clouds and (1,) int32 labels in file order. Without it the cache
    is built here by :func:`fps_cache` on ``FPS_DEVICE`` (the card unless the
    node says "cpu"; ``builder.dataset_builder`` sets it from the trainer's
    device), before any loader worker forks. An item is the cloud's xyz (and
    normals with ``USE_NORMALS``), normalised into the unit sphere, its rows
    shuffled for ``subset: train``. Without ``DATA_PATH``: the synthetic
    clouds."""

    def __init__(self, config):
        self.root = config.DATA_PATH
        self.npoints = config.N_POINTS
        self.use_normals = bool(config.get("USE_NORMALS", False))
        self.num_category = config.get("NUM_CATEGORY", 40)
        self.subset = config.subset
        self.rng = np.random.default_rng(0)
        if self._maybe_synthetic(self.root, "ModelNet"):
            self.list_of_labels = [i % self.num_category for i in range(self.synthetic_len)]
            self.list_of_points = None
            return
        cat = [line.rstrip() for line in open(os.path.join(self.root,
                                                           "modelnet40_shape_names.txt"))]
        classes = dict(zip(cat, range(len(cat))))
        shape_ids = [line.rstrip() for line in
                     open(os.path.join(self.root, f"modelnet40_{self.subset}.txt"))]
        shape_names = ["_".join(x.split("_")[0:-1]) for x in shape_ids]
        datapath = [(n, os.path.join(self.root, n, i) + ".txt")
                    for n, i in zip(shape_names, shape_ids)]
        # offline FPS cache (reference ModelNetDataset.py:86-116), the JAX dataset's file
        cache = os.path.join(self.root, f"modelnet{self.num_category}_{self.subset}_"
                                        f"{self.npoints}pts_fps.dat")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self.list_of_points, self.list_of_labels = pickle.load(f)
            return
        device = config.get("FPS_DEVICE", "cuda")
        self.list_of_points, parse_s, fps_s = fps_cache([p for _, p in datapath],
                                                        self.npoints, device)
        self.list_of_labels = [np.array([classes[n]]).astype(np.int32) for n, _ in datapath]
        n = len(datapath)
        self.cache_seconds = {"clouds": n, "parse": parse_s, "fps": fps_s}
        print(f"[DATASET] ModelNet {self.subset}: cached {n} clouds at {self.npoints} points "
              f"to {cache}: parse {parse_s:.2f} s ({n / max(parse_s, 1e-9):.1f} clouds/s), "
              f"FPS on {device} {fps_s:.2f} s ({n / max(fps_s, 1e-9):.1f} clouds/s)",
              flush=True)
        # a temporary file of this process, then one rename: ranks that all found no
        # cache each write a whole one, and a reader never sees a partial file
        tmp = f"{cache}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump((self.list_of_points, self.list_of_labels), f)
        os.replace(tmp, cache)

    def __len__(self):
        return len(self.list_of_labels)

    def __getitem__(self, idx):
        if self.synthetic:
            pts, label = synthetic_cloud(idx, self.npoints, self.num_category)
        else:
            pts = self.list_of_points[idx][:, 0:6 if self.use_normals else 3].copy()
            label = int(self.list_of_labels[idx][0])
            pts[:, 0:3] = pc_normalize(pts[:, 0:3])
        if self.subset == "train":
            pts = shuffle_rows(self.rng, pts)
        return "ModelNet", "sample", (pts.astype(np.float32), label)


@DATASETS.register_module()
class ModelNetFewShot(_SyntheticMixin):
    def __init__(self, config):
        self.root = config.DATA_PATH
        self.npoints = config.N_POINTS
        self.subset = config.subset
        self.way, self.shot, self.fold = config.way, config.shot, config.fold
        if self.way <= 0 or self.shot <= 0 or self.fold < 0:
            raise RuntimeError("few-shot way/shot/fold must be set "
                               "(reference ModelNetDatasetFewShot.py:39-41)")
        pkl = os.path.join(self.root, f"{self.way}way_{self.shot}shot", f"{self.fold}.pkl")
        if self._maybe_synthetic(pkl, "ModelNetFewShot"):
            per = self.shot if self.subset == "train" else 20
            self.dataset = [(synthetic_cloud(w * 131 + s, self.npoints, self.way)[0], w, w)
                            for w in range(self.way) for s in range(per)]
            return
        with open(pkl, "rb") as f:
            self.dataset = pickle.load(f)[self.subset]

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        points, label, _ = self.dataset[idx]
        points = points[:, :3].astype(np.float32)
        points[:, 0:3] = pc_normalize(points[:, 0:3])
        return "ModelNetFewShot", "sample", (points, int(label))


class _ScanObjectNNBase(_SyntheticMixin):
    h5_name = "objectdataset.h5"
    NUM_CLASSES = 15

    def __init__(self, config):
        self.subset = config.subset
        self.root = config.ROOT
        self.npoints = 2048
        self.rng = np.random.default_rng(0)
        prefix = "training" if self.subset == "train" else "test"
        h5 = os.path.join(self.root, f"{prefix}_{self.h5_name}")
        if self._maybe_synthetic(h5, "ScanObjectNN"):
            self.points = None
            self.labels = [i % self.NUM_CLASSES for i in range(self.synthetic_len)]
            return
        import h5py  # only for a real archive
        with h5py.File(h5, "r") as f:
            self.points = np.array(f["data"]).astype(np.float32)
            self.labels = np.array(f["label"]).astype(int)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        if self.synthetic:
            pts, label = synthetic_cloud(idx, self.npoints, self.NUM_CLASSES)
        else:
            pts, label = self.points[idx].copy(), int(self.labels[idx])
        if self.subset == "train":
            pts = shuffle_rows(self.rng, pts)
        return "ScanObjectNN", "sample", (pts.astype(np.float32), label)


@DATASETS.register_module()
class ScanObjectNN(_ScanObjectNNBase):
    h5_name = "objectdataset.h5"


@DATASETS.register_module()
class ScanObjectNN_hardest(_ScanObjectNNBase):
    h5_name = "objectdataset_augmentedrot_scale75.h5"
