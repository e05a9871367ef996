"""Batch augmentations and the synthetic point clouds."""
from act_tpu_torch.datasets.synthetic import synthetic_batch, synthetic_cloud
from act_tpu_torch.datasets.transforms import scale_and_translate

__all__ = ["scale_and_translate", "synthetic_batch", "synthetic_cloud"]
