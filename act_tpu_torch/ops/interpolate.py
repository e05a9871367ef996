"""3-NN inverse-distance feature interpolation (PointNet++ feature propagation).

Counterpart of ``act_tpu/ops/interpolate.py:34-60`` (reference
part_segmentation/models/pointnet2_utils.py:262-312). For every unknown point
the 3 nearest known points come from ``knn``: the distance product, then the
k-smallest kernel (``csrc/topk.cu``) at k=3 on rows of S centers on the card.
The JAX package blends through a dense (B, N, S) weight matrix and a one-hot
product, a TPU workaround; here the blend is three gathered feature rows
summed with their weights.

The blend is ``reference.nn_blend``, shared with the plain version
``three_nn_interpolate_ref``: the three squared distances are recomputed from
the indices in the difference form ``sum((x - y)**2)``, as
``interpolate.py:42-50`` does. The kernel's distances carry no gradient, and
the recomputed ones let autograd reach both coordinate arguments; at a query
that is itself a center (every FPS center is one of the N points) the
difference form gives an exact 0 where the kernel's expanded form may not.
"""
from __future__ import annotations

import torch

from act_tpu_torch.ops.group import knn
from act_tpu_torch.ops.reference import nn_blend


def three_nn_interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                         known_feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """unknown_xyz (B, N, 3), known_xyz (B, S, 3), known_feats (B, S, C) ->
    (B, N, C): the inverse-distance blend of each unknown point's k nearest
    known features. The neighbours are ascending, ties to the smaller index;
    on a CUDA tensor they come from the k-smallest kernel."""
    with torch.no_grad():
        _, idx = knn(known_xyz.contiguous(), unknown_xyz.contiguous(), k)
    return nn_blend(unknown_xyz, known_xyz, known_feats, idx)
