"""The MODELS registry (reference models/build.py)."""
from act_tpu_torch.utils.registry import Registry

MODELS = Registry("model")
