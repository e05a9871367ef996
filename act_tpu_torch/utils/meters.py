"""Running-average meters, the accuracy record and the balanced accuracy.

The port's own copy of ``act_tpu/utils/meters.py`` (reference
``utils/AverageMeter.py:2-42``, ``Acc_Metric``), and the mAcc that the JAX
runner takes from ``sklearn.metrics.balanced_accuracy_score``
(``runner_finetune.py:312-321``) in numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class AverageMeter:
    """Tracks the running mean of each named item."""

    def __init__(self, items: Sequence[str]):
        self.items = list(items)
        self.reset()

    def reset(self):
        self._sum = [0.0] * len(self.items)
        self._count = [0] * len(self.items)

    def update(self, values: Sequence[float]):
        for i, v in enumerate(values):
            self._sum[i] += float(v)
            self._count[i] += 1

    def avg(self, idx: int) -> float:
        return self._sum[idx] / max(self._count[idx], 1)


class AccMetric:
    """Scalar accuracy (%) with ``better_than`` (reference Acc_Metric,
    tools/runner_pretrain.py:28-45); a validation also reports its balanced
    accuracy ``macc`` (%), which does not rank."""

    def __init__(self, acc: float = 0.0, macc: float = float("nan")):
        self.acc = float(acc)
        self.macc = float(macc)

    def better_than(self, other: "AccMetric") -> bool:
        return self.acc > other.acc

    def state_dict(self):
        return {"acc": self.acc}


def balanced_accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    """The mean over the classes present in ``labels`` of each class's recall,
    in [0, 1] (``sklearn.metrics.balanced_accuracy_score`` without weights)."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    classes = np.unique(labels)
    return float(np.mean([(preds[labels == c] == c).mean() for c in classes]))
