"""Datasets, the loader, batch augmentations and the synthetic point clouds;
importing this package registers the datasets in ``DATASETS``."""
from act_tpu_torch.datasets import pointcloud_datasets  # noqa: F401  (registers)
from act_tpu_torch.datasets.build import DATASETS, build_dataset_from_cfg
from act_tpu_torch.datasets.loader import DataLoader, default_collate
from act_tpu_torch.datasets.synthetic import synthetic_batch, synthetic_cloud
from act_tpu_torch.datasets.transforms import rotate_y, scale_and_translate

__all__ = ["DATASETS", "DataLoader", "build_dataset_from_cfg", "default_collate",
           "rotate_y", "scale_and_translate", "synthetic_batch", "synthetic_cloud"]
