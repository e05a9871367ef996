"""Point-cloud preprocessing on host arrays, computed on the card.

Counterpart of ``act_tpu/native/__init__.py`` (its C++ ``pointops.cpp`` behind
ctypes): the same three functions, names and array contracts, numpy in and
numpy out. Each one moves its arrays to ``device``, runs the port's ops there
and brings the result back; on the card ``fps`` is the FPS kernel
(``csrc/fps.cu``) and ``knn`` the k-smallest kernel (``csrc/topk.cu``).
``device="cpu"`` runs their plain versions. There is no other fallback.

  idx = native.fps(clouds, 8192)              # (B, N, 3) -> (B, 8192) int64
  dist, idx = native.knn(ref, query, 16)      # (B, Q, 16) each
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from act_tpu_torch import ops
from act_tpu_torch.ops.reference import pair_distance


def _points(points: np.ndarray, device) -> Tuple[torch.Tensor, bool]:
    """(N, C) or (B, N, C) -> a (B, N, C) f32 tensor on ``device``, and
    whether the input was one cloud."""
    single = points.ndim == 2
    pts = np.ascontiguousarray(points[None] if single else points, dtype=np.float32)
    return torch.from_numpy(pts).to(ops.resolve_device(device)), single


def fps(points: np.ndarray, n_samples: int, device="cuda") -> np.ndarray:
    """Greedy farthest-point sampling from index 0 on the first three
    columns: (N, 3) or (B, N, 3) f32 -> int64 indices (S,) or (B, S), every
    cloud of a batch in one launch (``ops.furthest_point_sample``). On the
    card the picks equal the C++ loop's up to a swap of two adjacent picks at
    a one-ulp distance tie (the same set, ``ops.fps.tie_swaps``); on the CPU
    they are equal."""
    pts, single = _points(points, device)
    idx = ops.furthest_point_sample(pts[..., :3].contiguous(), int(n_samples))
    out = idx.long().cpu().numpy()
    return out[0] if single else out


def normalize(points: np.ndarray, device="cuda") -> np.ndarray:
    """Each cloud's xyz centred on its mean and scaled into the unit sphere,
    other columns as they were: (N, C>=3) or (B, N, C>=3) f32, a new array.

    The C++ sums the centroid in f64 and rounds it to f32 once; here the
    mean is an f32 reduction (pairwise on the CPU, tree-ordered on the card),
    so a coordinate can differ from the C++'s by a few ulp of the cloud's
    extent: within 1e-6 for clouds of unit scale (the tests' tolerance)."""
    pts, single = _points(points, device)
    xyz = pts[..., :3] - pts[..., :3].mean(dim=1, keepdim=True)
    radius = torch.sqrt((xyz * xyz).sum(-1).amax(dim=1))
    pts[..., :3] = xyz * (1.0 / (radius + 1e-12))[:, None, None]
    out = pts.cpu().numpy()
    return out[0] if single else out


def knn(ref: np.ndarray, query: np.ndarray, k: int, device="cuda"
        ) -> Tuple[np.ndarray, np.ndarray]:
    """ref (B, N, 3), query (B, Q, 3) -> (squared distances f32, int64
    indices), each (B, Q, k), ascending, ties to the smaller index, as the
    C++ insertion sort orders them. The distances are the C++'s own form,
    ``(dx*dx + dy*dy) + dz*dz`` (``ops.reference.pair_distance``, not the
    expanded form of ``ops.square_distance``), so values and ranks equal
    the C++'s; the selection is ``ops.k_smallest``."""
    r, _ = _points(ref, device)
    q, _ = _points(query, device)
    d = pair_distance(q[..., :3].contiguous(), r[..., :3].contiguous())
    dist, idx = ops.k_smallest(d.contiguous(), int(k))
    return dist.cpu().numpy(), idx.long().cpu().numpy()
