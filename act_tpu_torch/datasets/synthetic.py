"""Deterministic synthetic point clouds for data-free runs.

A copy of ``act_tpu/datasets/synthetic.py:15-54``: the same seeded mixture of
simple shapes, so both packages see the same clouds for the same index. The
JAX package's ShapeNet-55 fallback serves indices 0..511
(``act_tpu/datasets/pointcloud_datasets.py:61-62``).
"""
from __future__ import annotations

import numpy as np

SYNTHETIC_LEN = 512  # samples in the JAX package's synthetic ShapeNet-55


def synthetic_cloud(index: int, npoints: int, num_classes: int = 55,
                    seed: int = 1234) -> tuple:
    """Returns (points (npoints, 3) float32 unit-sphere, label int)."""
    rng = np.random.default_rng(seed + index * 9973)
    label = int(index % num_classes)
    kind = label % 4
    n = npoints
    if kind == 0:  # sphere shell with lobes
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        r = 1.0 + 0.2 * np.sin((label + 1) * v[:, 0] * 3)
        pts = v * r[:, None]
    elif kind == 1:  # box surface
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-1, 1, size=(n, 2))
        pts = np.zeros((n, 3))
        axis = face % 3
        sign = np.where(face < 3, 1.0, -1.0)
        for a in range(3):
            m = axis == a
            o = [b for b in range(3) if b != a]
            pts[m, a] = sign[m]
            pts[m, o[0]] = uv[m, 0]
            pts[m, o[1]] = uv[m, 1]
    elif kind == 2:  # cylinder + cap
        t = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-1, 1, n)
        rad = 0.5 + 0.02 * label
        pts = np.stack([rad * np.cos(t), rad * np.sin(t), z], axis=1)
    else:  # torus
        t = rng.uniform(0, 2 * np.pi, n)
        p = rng.uniform(0, 2 * np.pi, n)
        R, r = 0.8, 0.25 + 0.01 * label
        pts = np.stack([(R + r * np.cos(p)) * np.cos(t),
                        (R + r * np.cos(p)) * np.sin(t),
                        r * np.sin(p)], axis=1)
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    pts = pts - pts.mean(0)
    pts = pts / (np.abs(np.linalg.norm(pts, axis=1)).max() + 1e-9)
    return pts.astype(np.float32), label


def synthetic_batch(step: int, batch: int, npoints: int) -> np.ndarray:
    """Batch ``step`` of the synthetic ShapeNet-55 in index order:
    (batch, npoints, 3) float32, indices ``step * batch + b`` modulo 512."""
    return np.stack([synthetic_cloud((step * batch + b) % SYNTHETIC_LEN, npoints)[0]
                     for b in range(batch)])
