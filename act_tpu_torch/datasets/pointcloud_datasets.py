"""The classification datasets: ModelNet40, its few-shot splits and ScanObjectNN.

Counterpart of ``act_tpu/datasets/pointcloud_datasets.py:36-72, 178-322``
(reference datasets/ModelNetDataset.py, ModelNetDatasetFewShot.py,
ScanObjectNNDataset.py). Each class returns numpy samples
``(taxonomy_id, model_id, (points, label))``. When the configured data is
missing, a class serves the JAX package's deterministic synthetic clouds
(``datasets/synthetic.py``): the same samples, labels and train-time point
shuffles, bit for bit. ``h5py`` is imported only to read a real ScanObjectNN
archive.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from act_tpu_torch.datasets.build import DATASETS
from act_tpu_torch.datasets.synthetic import synthetic_cloud
from act_tpu_torch.utils.misc import pc_normalize


def farthest_point_sample_np(point: np.ndarray, npoint: int) -> np.ndarray:
    """Host FPS of one (N, D) cloud on its first three columns, from index 0,
    for the offline ModelNet cache (reference ModelNetDataset.py:29-50)."""
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
class ModelNet(_SyntheticMixin):
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
        # offline FPS cache (reference ModelNetDataset.py:86-116)
        cache = os.path.join(self.root, f"modelnet{self.num_category}_{self.subset}_"
                                        f"{self.npoints}pts_fps.dat")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self.list_of_points, self.list_of_labels = pickle.load(f)
            return
        self.list_of_points, self.list_of_labels = [], []
        for name, path in datapath:
            point_set = np.loadtxt(path, delimiter=",").astype(np.float32)
            self.list_of_points.append(farthest_point_sample_np(point_set, self.npoints))
            self.list_of_labels.append(np.array([classes[name]]).astype(np.int32))
        with open(cache, "wb") as f:
            pickle.dump((self.list_of_points, self.list_of_labels), f)

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
            self.rng.shuffle(pts)
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
            self.rng.shuffle(pts)
        return "ScanObjectNN", "sample", (pts.astype(np.float32), label)


@DATASETS.register_module()
class ScanObjectNN(_ScanObjectNNBase):
    h5_name = "objectdataset.h5"


@DATASETS.register_module()
class ScanObjectNN_hardest(_ScanObjectNNBase):
    h5_name = "objectdataset_augmentedrot_scale75.h5"
