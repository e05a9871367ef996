"""``act_tpu_torch.native`` and the ModelNet offline FPS cache held against the
JAX package on the CPU.

- ``native.fps`` and ``native.knn`` (``device="cpu"``: the plain versions of
  the FPS and k-smallest kernels) equal ``act_tpu.native``'s C++ exactly,
  indices and distances, on seeded clouds, on a cloud of repeated points
  (FPS repeats an early index once every distance is 0) and on a single
  cloud; ``normalize`` within 1e-6 (the C++ sums the centroid in f64);
- the port's cache of a small written ``modelnet40_normal_resampled`` tree
  (clouds of 6 columns, one of another point count, written at ``%.6f`` as
  the real files are) is the JAX dataset's file byte for byte, each package
  reads the other's file into the same items, and a batch of clouds of
  mixed point counts gives each cloud the plain loop's picks.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from act_tpu import native as jnative
from act_tpu.datasets import pointcloud_datasets as jpcd
from act_tpu.utils.config import ConfigDict as JConfigDict

from act_tpu_torch import native
from act_tpu_torch.datasets import pointcloud_datasets as pcd
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

CLASSES = ("airplane", "bathtub", "chair")
N_POINTS = 200


def repeated_cloud(rng, distinct=50, n=300):
    return rng.normal(size=(distinct, 3)).astype(np.float32)[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("B,N,S", [(3, 1000, 300), (2, 777, 777), (1, 64, 1)])
def test_fps_equals_the_cpp(rng, B, N, S):
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    got = native.fps(pts, S, device="cpu")
    assert got.dtype == np.int64 and got.shape == (B, S)
    np.testing.assert_array_equal(got, jnative.fps(pts, S))
    np.testing.assert_array_equal(native.fps(pts[0], S, device="cpu"), jnative.fps(pts[0], S))


def test_fps_on_repeated_points_equals_the_cpp_and_the_loop(rng):
    """250 picks from 50 distinct points: after the 50th every distance is 0
    and the first argmax (index 0) repeats."""
    pts = repeated_cloud(rng)
    got = native.fps(pts, 250, device="cpu")
    np.testing.assert_array_equal(got, jnative.fps(pts, 250))
    np.testing.assert_array_equal(pts[got], pcd.farthest_point_sample_np(pts, 250))
    assert len(np.unique(pts[got], axis=0)) == 50 and (got[60:] == 0).all()


@pytest.mark.parametrize("k", [1, 3, 16])
def test_knn_equals_the_cpp(rng, k):
    ref = rng.normal(size=(2, 400, 3)).astype(np.float32)
    query = np.concatenate([rng.normal(size=(2, 30, 3)), ref[:, :5]], 1).astype(np.float32)
    ref[:, 100] = ref[:, 7]  # a duplicate point: a tie, to the smaller index
    got_d, got_i = native.knn(ref, query, k, device="cpu")
    want_d, want_i = jnative.knn(ref, query, k)
    assert got_i.dtype == np.int64 and got_i.shape == (2, 35, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_normalize_within_its_tolerance(rng):
    pts = (rng.normal(size=(3, 500, 6)) * 5 + 3).astype(np.float32)
    got = native.normalize(pts, device="cpu")
    np.testing.assert_allclose(got, jnative.normalize(pts), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3:], pts[..., 3:])
    np.testing.assert_allclose(native.normalize(pts[1], device="cpu"), got[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the offline cache
# ---------------------------------------------------------------------------

def write_tree(root, rng):
    """A ``modelnet40_normal_resampled``-shaped tree: 2 clouds a class for
    train and 1 for test, 6 columns at %.6f, 300 points a cloud but one train
    cloud of 260."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(CLASSES) + "\n")
    splits = {"train": [], "test": []}
    for c, name in enumerate(CLASSES):
        os.makedirs(os.path.join(root, name))
        for i in range(3):
            sid = f"{name}_{i + 1:04d}"
            n = 260 if (c, i) == (1, 0) else 300
            pts = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(-1, 1, (n, 3))], 1)
            np.savetxt(os.path.join(root, name, sid + ".txt"), pts, fmt="%.6f",
                       delimiter=",")
            splits["test" if i == 2 else "train"].append(sid)
    for split, ids in splits.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def node(root, subset):
    return dict(NAME="ModelNet", DATA_PATH=root, N_POINTS=N_POINTS, NUM_CATEGORY=40,
                USE_NORMALS=False, subset=subset, FPS_DEVICE="cpu")


def cache_file(root, subset):
    return os.path.join(root, f"modelnet40_{subset}_{N_POINTS}pts_fps.dat")


@pytest.mark.parametrize("subset", ["train", "test"])
def test_cache_is_the_jax_file_and_each_package_reads_the_other(tmp_path, rng, subset):
    write_tree(str(tmp_path / "port"), rng)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    port = pcd.ModelNet(ConfigDict(node(str(tmp_path / "port"), subset)))
    assert port.cache_seconds["clouds"] == len(port) == (6 if subset == "train" else 3)
    jax_ds = jpcd.ModelNet(JConfigDict(node(str(tmp_path / "jax"), subset)))
    a, b = cache_file(str(tmp_path / "port"), subset), cache_file(str(tmp_path / "jax"), subset)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    with open(a, "rb") as f:
        points, labels = pickle.load(f)
    assert [p.shape for p in points] == [(N_POINTS, 6)] * len(points)
    assert all(p.dtype == np.float32 for p in points)
    assert [(lb.dtype, lb.shape) for lb in labels] == [(np.dtype(np.int32), (1,))] * len(labels)
    # each reads the other's file: swap them and compare the items
    shutil.copy(a, tmp_path / "swap")
    shutil.copy(b, a)
    shutil.copy(tmp_path / "swap", b)
    port_b = pcd.ModelNet(ConfigDict(node(str(tmp_path / "port"), subset)))
    jax_b = jpcd.ModelNet(JConfigDict(node(str(tmp_path / "jax"), subset)))
    assert not hasattr(port_b, "cache_seconds")  # read, not built
    for i in range(len(port_b)):
        for x, y in ((port_b[i], jax_b[i]), (port[i], jax_ds[i])):
            assert x[2][1] == y[2][1]
            np.testing.assert_array_equal(x[2][0], y[2][0])


def test_cache_batches_mixed_point_counts(tmp_path, rng):
    """Launches of two clouds: the 260-point cloud shares no launch with
    the 300-point ones, and every cloud keeps the plain loop's picks, in
    file order."""
    write_tree(str(tmp_path), rng)
    with open(tmp_path / "modelnet40_train.txt") as f:
        ids = f.read().split()
    paths = [str(tmp_path / "_".join(i.split("_")[:-1]) / f"{i}.txt") for i in ids]
    got, parse_s, fps_s = pcd.fps_cache(paths, N_POINTS, "cpu", batch=2)
    assert parse_s > 0 and fps_s > 0
    for path, g in zip(paths, got, strict=True):
        cloud = np.loadtxt(path, delimiter=",").astype(np.float32)
        np.testing.assert_array_equal(g, pcd.farthest_point_sample_np(cloud, N_POINTS))
