"""Models; importing this package registers them in ``MODELS``."""
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.point_transformer import Mlp3Head, PointTransformer

__all__ = ["MODELS", "Mlp3Head", "PointTransformer"]
