"""Reconstruction metrics: F-Score@0.01, CDL1 and CDL2 (x1000).

Counterpart of ``act_tpu/utils/metrics.py:18-88`` (reference
utils/metrics.py). The distances come from ``ops.chamfer_*``, so on the card
they are the distance-only Chamfer kernel (nothing takes a gradient here),
launched once a cloud for all three metrics.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from act_tpu_torch import ops
from act_tpu_torch.ops.chamfer import l1_from_distances, l2_from_distances


def _batched(t: torch.Tensor) -> torch.Tensor:
    return t[None] if t.dim() == 2 else t


class Metrics:
    # a validation's per-taxonomy breakdown: {taxonomy: (clouds, [F-Score,
    # CDL1, CDL2] means)}, set by ``runner_autoencoder.validate``
    table = None
    ITEMS = [
        {"name": "F-Score", "is_greater_better": True, "init_value": 0.0},
        {"name": "CDL1", "is_greater_better": False, "init_value": 32767.0},
        {"name": "CDL2", "is_greater_better": False, "init_value": 32767.0},
    ]

    @classmethod
    def names(cls) -> List[str]:
        return [i["name"] for i in cls.ITEMS]

    @staticmethod
    def get(pred: torch.Tensor, gt: torch.Tensor, th: float = 0.01) -> List[float]:
        """pred (N, 3) or (B, N, 3), gt (M, 3) or (B, M, 3) -> [F-Score at
        distance ``th`` (reference utils/metrics.py:57-76), CDL1, CDL2], all
        three from one Chamfer call."""
        d1, d2 = ops.chamfer_distances(_batched(pred), _batched(gt))  # squared
        recall = float((torch.sqrt(d2) < th).double().mean())
        precision = float((torch.sqrt(d1) < th).double().mean())
        f_score = 2 * recall * precision / (recall + precision) if recall + precision else 0.0
        return [f_score, float(l1_from_distances(d1, d2)) * 1000.0,
                float(l2_from_distances(d1, d2)) * 1000.0]

    def __init__(self, metric_name: str, values):
        self.metric_name = metric_name
        self._values = [item["init_value"] for item in self.ITEMS]
        if isinstance(values, Metrics):
            self._values = list(values._values)
        elif isinstance(values, dict):
            for k, v in values.items():
                if k in self.names():
                    self._values[self.names().index(k)] = v
        else:
            self._values = list(values)

    def state_dict(self) -> Dict[str, float]:
        return dict(zip(self.names(), self._values))

    def better_than(self, other: "Metrics") -> bool:
        if other is None:
            return True
        i = self.names().index(self.metric_name)
        if self.ITEMS[i]["is_greater_better"]:
            return self._values[i] > other._values[i]
        return self._values[i] < other._values[i]
