"""Models; importing this package registers them in ``MODELS``."""
from act_tpu_torch.models.act import (ACT_PointBERT, ACT_PointDistillation, MaskTransformer,
                                      TokenAllMaskTransformer, VisableOnlyMaskTransformer)
from act_tpu_torch.models.build import MODELS
from act_tpu_torch.models.dvae import (ACTPromptedDiscreteVAEwithBERT,
                                       ACTPromptedDiscreteVAEwithVIT, DiscreteVAE)
from act_tpu_torch.models.point_transformer import Mlp3Head, PointTransformer
from act_tpu_torch.models.segmentation import PartSegTransformer, SemSegTransformer
from act_tpu_torch.models.teacher import PromptedTeacher

__all__ = ["MODELS", "ACT_PointBERT", "ACT_PointDistillation", "ACTPromptedDiscreteVAEwithBERT",
           "ACTPromptedDiscreteVAEwithVIT",
           "DiscreteVAE", "MaskTransformer", "Mlp3Head", "PartSegTransformer", "PointTransformer",
           "PromptedTeacher", "SemSegTransformer", "TokenAllMaskTransformer",
           "VisableOnlyMaskTransformer"]
