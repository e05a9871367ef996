"""Models; importing this package registers them in ``MODELS``."""
from act_tpu_torch.models.act import ACT_PointDistillation, VisableOnlyMaskTransformer
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.dvae import ACTPromptedDiscreteVAEwithVIT, DiscreteVAE
from act_tpu_torch.models.point_transformer import Mlp3Head, PointTransformer
from act_tpu_torch.models.teacher import PromptedTeacher

__all__ = ["MODELS", "ACT_PointDistillation", "ACTPromptedDiscreteVAEwithVIT",
           "DiscreteVAE", "Mlp3Head", "PointTransformer", "PromptedTeacher",
           "VisableOnlyMaskTransformer"]
