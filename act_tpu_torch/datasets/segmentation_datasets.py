"""Segmentation datasets: ShapeNetPart (``PartNormalDataset``), S3DIS blocks and
the whole-scene sliding-window evaluation blocks.

Counterpart of ``act_tpu/datasets/segmentation_datasets.py`` (reference
part_segmentation/dataset.py:64-163, semantic_segmentation/dataset.py:72-148
and ScannetDatasetWholeScene :150+): the category file and the json splits,
resampling with ``rng.choice``; S3DIS rooms (N x 7 ``.npy``, xyzrgb + label)
cut into 1 m blocks around a random point with more than 1024 points, the
inverse-frequency label weights ^(1/3); the whole-scene windows padded to
multiples of ``num_point``. Each dataset draws from its own
``default_rng(0)`` in the same order as the JAX package, so the same
indices give the same items. When the data are absent the datasets serve
the JAX package's synthetic clouds with geometric part labels.
"""
from __future__ import annotations

import json
import os

import numpy as np

from act_tpu_torch.datasets.pointcloud_datasets import _SyntheticMixin
from act_tpu_torch.datasets.synthetic import synthetic_cloud
from act_tpu_torch.utils.logger import print_log
from act_tpu_torch.utils.misc import pc_normalize

SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}
NUM_PART_CLASSES = 50
NUM_SHAPE_CATEGORIES = 16
S3DIS_NUM_CLASSES = 13


def _z_slices(z: np.ndarray, parts: int) -> np.ndarray:
    """Label each point by its z quantile slice, 0 .. parts - 1."""
    return np.searchsorted(np.quantile(z, np.linspace(0, 1, parts + 1)[1:-1]), z)


def _synthetic_part_sample(index: int, npoints: int):
    """A synthetic cloud with geometric parts: category ``index % 16`` in
    sorted order, its parts assigned by z slice."""
    cats = sorted(SEG_CLASSES)
    cat = cats[index % NUM_SHAPE_CATEGORIES]
    pts, _ = synthetic_cloud(index, npoints, NUM_SHAPE_CATEGORIES)
    parts = SEG_CLASSES[cat]
    seg = parts[0] + _z_slices(pts[:, 2], len(parts))
    return pts.astype(np.float32), cats.index(cat), seg.astype(np.int64)


class PartNormalDataset(_SyntheticMixin):
    """ShapeNetPart shapes as (points (npoints, 3 or 6), category id, part
    labels (npoints,)), resampled with replacement by ``rng.choice``;
    ``split`` is 'train', 'val', 'trainval' or 'test'."""

    def __init__(self, root: str, npoints: int = 2048, split: str = "train",
                 class_choice=None, normal_channel: bool = False):
        self.npoints = npoints
        self.root = root
        self.normal_channel = normal_channel
        self.split = split
        self.rng = np.random.default_rng(0)
        self.cache = {}
        self.seg_classes = SEG_CLASSES
        if self._maybe_synthetic(os.path.join(root, "synsetoffset2category.txt"),
                                 "ShapeNetPart"):
            self.datapath = [("synthetic", i) for i in range(self.synthetic_len)]
            self.classes = {c: i for i, c in enumerate(sorted(SEG_CLASSES))}
            return

        self.cat = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                ls = line.strip().split()
                self.cat[ls[0]] = ls[1]
        classes_original = dict(zip(self.cat, range(len(self.cat))))
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k in class_choice}

        def load_ids(name):
            with open(os.path.join(root, "train_test_split", name)) as f:
                return set(str(d.split("/")[2]) for d in json.load(f))
        ids = {s: load_ids(f"shuffled_{s}_file_list.json") for s in ("train", "val", "test")}
        keep = ids["train"] | ids["val"] if split == "trainval" else ids.get(split, ids["test"])
        self.datapath = []
        for item, synset in self.cat.items():
            dir_point = os.path.join(root, synset)
            self.datapath += [(item, os.path.join(dir_point, fn))
                              for fn in sorted(os.listdir(dir_point)) if fn[0:-4] in keep]
        self.classes = {k: classes_original[k] for k in self.cat}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if self.synthetic:
            return _synthetic_part_sample(index, self.npoints)
        if index in self.cache:
            point_set, cls, seg = self.cache[index]
        else:
            cat, fn = self.datapath[index]
            cls = self.classes[cat]
            data = np.loadtxt(fn).astype(np.float32)
            point_set = data[:, 0:6] if self.normal_channel else data[:, 0:3]
            seg = data[:, -1].astype(np.int64)
            if len(self.cache) < 20000:
                self.cache[index] = (point_set, cls, seg)
        point_set = point_set.copy()
        point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        choice = self.rng.choice(len(seg), self.npoints, replace=True)
        return point_set[choice], cls, seg[choice]


class S3DISDataset(_SyntheticMixin):
    """S3DIS blocks as (points (num_point, 3) centred in x and y, labels
    (num_point,)): rooms of Area ``test_area`` for 'test', the others for
    'train', each item a 1 m block around a random point of a room drawn in
    proportion to its points."""

    def __init__(self, split: str = "train", data_root: str = "trainval_fullarea",
                 num_point: int = 2048, test_area: int = 5, block_size: float = 1.0,
                 sample_rate: float = 1.0):
        self.num_point = num_point
        self.block_size = block_size
        self.split = split
        self.rng = np.random.default_rng(0)
        if self._maybe_synthetic(data_root, "S3DIS"):
            self.labelweights = np.ones(S3DIS_NUM_CLASSES, np.float32)
            self.room_idxs = np.zeros(self.synthetic_len, np.int64)
            return

        rooms = sorted(r for r in os.listdir(data_root) if "Area_" in r)
        in_test = [f"Area_{test_area}" in r for r in rooms]
        rooms = [r for r, t in zip(rooms, in_test) if t == (split != "train")]
        self.room_points, self.room_labels = [], []
        self.room_coord_min, self.room_coord_max = [], []
        num_point_all = []
        counts = np.zeros(S3DIS_NUM_CLASSES)
        for room_name in rooms:
            room_data = np.load(os.path.join(data_root, room_name))  # N x 7
            points, labels = room_data[:, 0:6], room_data[:, 6]
            counts += np.histogram(labels, range(S3DIS_NUM_CLASSES + 1))[0]
            self.room_points.append(points)
            self.room_labels.append(labels)
            self.room_coord_min.append(points[:, :3].min(0))
            self.room_coord_max.append(points[:, :3].max(0))
            num_point_all.append(labels.size)
        freq = counts.astype(np.float32)
        freq = freq / freq.sum()
        self.labelweights = np.power(freq.max() / freq, 1 / 3.0)  # inverse frequency ^ (1/3)
        sample_prob = np.asarray(num_point_all) / np.sum(num_point_all)
        num_iter = int(np.sum(num_point_all) * sample_rate / num_point)
        room_idxs = []
        for index in range(len(rooms)):
            room_idxs.extend([index] * int(round(sample_prob[index] * num_iter)))
        self.room_idxs = np.array(room_idxs)
        print_log(f"[S3DIS] {len(self.room_idxs)} samples in {split}", logger="S3DIS")

    def __len__(self):
        return len(self.room_idxs)

    def __getitem__(self, idx):
        if self.synthetic:
            pts, _ = synthetic_cloud(idx, self.num_point, S3DIS_NUM_CLASSES)
            labels = _z_slices(pts[:, 2], S3DIS_NUM_CLASSES)
            return pts.astype(np.float32), labels.astype(np.int64)
        room_idx = self.room_idxs[idx]
        points = self.room_points[room_idx]
        labels = self.room_labels[room_idx]
        N = points.shape[0]
        while True:  # a block with more than 1024 points
            center = points[self.rng.choice(N)][:3]
            bmin = center - [self.block_size / 2, self.block_size / 2, 0]
            bmax = center + [self.block_size / 2, self.block_size / 2, 0]
            idxs = np.where((points[:, 0] >= bmin[0]) & (points[:, 0] <= bmax[0])
                            & (points[:, 1] >= bmin[1]) & (points[:, 1] <= bmax[1]))[0]
            if idxs.size > 1024:
                break
        sel = self.rng.choice(idxs, self.num_point, replace=idxs.size < self.num_point)
        selected = points[sel].copy()
        selected[:, 0] -= center[0]
        selected[:, 1] -= center[1]
        return selected[:, :3].astype(np.float32), labels[sel].astype(np.int64)


class WholeSceneDataset(_SyntheticMixin):
    """The rooms of Area ``test_area`` whole, for the sliding-window vote
    (reference ScannetDatasetWholeScene, used by main_test.py); synthetic:
    two 8192-point clouds spread into a 4 m room."""

    def __init__(self, root: str, num_point: int = 2048, test_area: int = 5,
                 stride: float = 0.5, block_size: float = 1.0, padding: float = 0.001):
        self.num_point = num_point
        self.block_size = block_size
        self.stride = stride
        self.padding = padding
        self.rng = np.random.default_rng(0)
        self.scene_points, self.semantic_labels = [], []
        if self._maybe_synthetic(root, "S3DIS-wholescene"):
            for i in range(2):
                pts, _ = synthetic_cloud(i, 8192, S3DIS_NUM_CLASSES)
                pts = (pts + 1.0) * 2.0  # spread into a 4 m room
                self.scene_points.append(pts.astype(np.float32))
                self.semantic_labels.append(_z_slices(pts[:, 2], S3DIS_NUM_CLASSES))
            self.labelweights = np.ones(S3DIS_NUM_CLASSES, np.float32)
            return
        rooms = sorted(r for r in os.listdir(root) if "Area_" in r and f"Area_{test_area}" in r)
        counts = np.zeros(S3DIS_NUM_CLASSES)
        for room in rooms:
            data = np.load(os.path.join(root, room))
            self.scene_points.append(data[:, :3].astype(np.float32))
            self.semantic_labels.append(data[:, 6].astype(np.int64))
            counts += np.histogram(data[:, 6], range(S3DIS_NUM_CLASSES + 1))[0]
        freq = counts.astype(np.float32) / counts.sum()  # divided by the f64 sum, as in JAX
        self.labelweights = np.power(freq.max() / freq, 1 / 3.0)

    def __len__(self):
        return len(self.scene_points)

    def blocks_for_scene(self, index):
        """Yield (points (num_point, 3) block-centred, labels, point indices)
        for every window of the scene that holds points, each window's points
        shuffled and padded by ``rng.choice`` to a multiple of num_point, so
        every point is covered."""
        points = self.scene_points[index]
        labels = self.semantic_labels[index]
        coord_min, coord_max = points.min(0), points.max(0)
        grid_x = int(np.ceil((coord_max[0] - coord_min[0] - self.block_size) / self.stride)) + 1
        grid_y = int(np.ceil((coord_max[1] - coord_min[1] - self.block_size) / self.stride)) + 1
        for ix in range(grid_x):
            for iy in range(grid_y):
                sx = coord_min[0] + ix * self.stride
                sy = coord_min[1] + iy * self.stride
                ex, ey = sx + self.block_size, sy + self.block_size
                m = ((points[:, 0] >= sx - self.padding) & (points[:, 0] <= ex + self.padding)
                     & (points[:, 1] >= sy - self.padding) & (points[:, 1] <= ey + self.padding))
                idxs = np.where(m)[0]
                if idxs.size == 0:
                    continue
                shuffled = self.rng.permutation(idxs)
                pad = (-len(shuffled)) % self.num_point
                if pad:
                    shuffled = np.concatenate([shuffled, self.rng.choice(idxs, pad)])
                for c in range(len(shuffled) // self.num_point):
                    sel = shuffled[c * self.num_point:(c + 1) * self.num_point]
                    block = points[sel].copy()
                    block[:, 0] -= (sx + self.block_size / 2)
                    block[:, 1] -= (sy + self.block_size / 2)
                    yield block.astype(np.float32), labels[sel], sel
