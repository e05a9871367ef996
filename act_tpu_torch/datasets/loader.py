"""Host-side batch loader: numpy collation in one process.

Counterpart of ``act_tpu/datasets/loader.py:51-204`` without its worker pool,
prefetch thread and replicas (one process on one card): the sample order of
an epoch is ``default_rng(seed + epoch).permutation`` when shuffled, and
``drop_last`` leaves out the last partial batch, so both packages batch the
same samples in the same order.
"""
from __future__ import annotations

from typing import Any, Iterator, List

import numpy as np


def default_collate(samples: List[Any]):
    """Stack the leaves of (taxonomy, model_id, data) samples."""
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (int, np.integer)):
        return np.asarray(samples, dtype=np.int32)
    if isinstance(first, float):
        return np.asarray(samples, dtype=np.float32)
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    return list(samples)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield default_collate([self.dataset[int(i)] for i in chunk])
