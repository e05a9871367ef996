"""Point-cloud ops: CUDA kernels on the card, their plain versions on the CPU."""
from act_tpu_torch.ops._backend import LAUNCHES, reset_launches, resolve_device
from act_tpu_torch.ops.chamfer import (chamfer_distance_l1, chamfer_distance_l2,
                                       chamfer_distance_l2_split, chamfer_distances)
from act_tpu_torch.ops.fps import furthest_point_sample
from act_tpu_torch.ops.gather import gather_coords
from act_tpu_torch.ops.group import (fps_subsample, fps_subsample_by, graph_feature_idx,
                                     group_points, knn)
from act_tpu_torch.ops.interpolate import three_nn_interpolate
from act_tpu_torch.ops.reference import (chamfer_bwd_ref, chamfer_min_ref, chamfer_ref,
                                         furthest_point_sample_ref,
                                         gather_points, graph_feature_idx_ref,
                                         group_points_ref, gumbel_argmax_ref,
                                         gumbel_perturbed_ref, k_smallest_ref,
                                         knn_ref, square_distance, three_nn_interpolate_ref)
from act_tpu_torch.ops.sampling import draw_seed, gumbel_argmax
from act_tpu_torch.ops.topk import k_smallest

__all__ = [
    "LAUNCHES", "reset_launches", "resolve_device", "chamfer_distance_l1",
    "chamfer_distance_l2", "chamfer_distance_l2_split", "chamfer_distances",
    "furthest_point_sample", "fps_subsample", "fps_subsample_by", "gather_coords",
    "graph_feature_idx", "group_points", "knn",
    "chamfer_bwd_ref", "chamfer_min_ref", "chamfer_ref",
    "furthest_point_sample_ref", "gather_points", "graph_feature_idx_ref",
    "group_points_ref", "gumbel_argmax_ref", "gumbel_perturbed_ref",
    "k_smallest_ref", "knn_ref", "square_distance", "draw_seed",
    "gumbel_argmax", "k_smallest", "three_nn_interpolate", "three_nn_interpolate_ref",
]
