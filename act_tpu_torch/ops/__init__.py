"""Point-cloud ops: CUDA kernels on the card, their plain versions on the CPU."""
from act_tpu_torch.ops._backend import LAUNCHES, reset_launches, resolve_device
from act_tpu_torch.ops.fps import furthest_point_sample
from act_tpu_torch.ops.gather import gather_coords
from act_tpu_torch.ops.group import group_points, knn
from act_tpu_torch.ops.reference import (furthest_point_sample_ref,
                                         gather_points, group_points_ref,
                                         k_smallest_ref, knn_ref,
                                         square_distance)
from act_tpu_torch.ops.topk import k_smallest

__all__ = [
    "LAUNCHES", "reset_launches", "resolve_device", "furthest_point_sample",
    "gather_coords", "group_points", "knn", "furthest_point_sample_ref",
    "gather_points", "group_points_ref", "k_smallest_ref", "knn_ref",
    "square_distance", "k_smallest",
]
