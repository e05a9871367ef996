"""The DATASETS registry (reference datasets/build.py:4-14); a copy of
``act_tpu/datasets/build.py``."""
from act_tpu_torch.utils.config import ConfigDict
from act_tpu_torch.utils.registry import Registry

DATASETS = Registry("dataset")


def build_dataset_from_cfg(cfg):
    """A dataset node ({_base_: <file cfg>, others: {...}}, merged leaf over
    base, or a flat node with NAME) -> the registered dataset."""
    if "_base_" in cfg:
        merged = ConfigDict(cfg["_base_"])
        merged.update(cfg.get("others", {}))
    else:
        merged = ConfigDict(cfg)
    return DATASETS.build(merged)
