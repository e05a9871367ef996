"""Host-side batch loader: numpy collation, a prefetch thread and a forked
worker pool.

Counterpart of ``act_tpu/datasets/loader.py:27-50, 66-204`` without its
replicas (one process on one card). The sample order of an epoch is
``default_rng(seed + epoch).permutation`` when shuffled, ``drop_last`` leaves
out the last partial batch, ``set_epoch(epoch, start_batch)`` starts the
epoch at a later batch, and a dataset's ``get_batch(indices)`` builds a
batch in one pass where it has one. So both packages batch the same samples
in the same order.

``prefetch`` batches are built ahead on a thread. With ``num_workers > 0``
batches come from a pool of forked processes, in order, each worker with a
dataset ``rng`` of its own (``_init_worker``). The workers run numpy only:
a dataset holds no CUDA tensor, and nothing in a worker touches
``torch.cuda``, so the pool may fork after the card is in use.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Iterator, List

import numpy as np

_WORKER_DS = None  # a worker's dataset, set by the pool's initializer


def _init_worker(dataset, seed_counter, base_seed) -> None:
    """Give each forked worker its own draws: seed ``base_seed + id *
    1000003`` for the global numpy generator and the dataset's ``rng``
    (a forked worker would otherwise replay its parent's draws)."""
    global _WORKER_DS
    _WORKER_DS = dataset
    with seed_counter.get_lock():
        worker_id = seed_counter.value
        seed_counter.value += 1
    seed = (int(base_seed) + worker_id * 1_000_003) % (2 ** 31)
    np.random.seed(seed)
    if hasattr(dataset, "rng"):
        dataset.rng = np.random.default_rng(seed)


def _fetch_chunk(chunk):
    return _collate_chunk(_WORKER_DS, chunk)


def _collate_chunk(dataset, chunk):
    if hasattr(dataset, "get_batch"):
        return dataset.get_batch(chunk)
    return default_collate([dataset[int(i)] for i in chunk])


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
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        self.epoch = 0
        self.start_batch = 0
        self._pool = None

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Epoch ``epoch`` from its batch ``start_batch`` on; the order is a
        function of (seed, epoch) alone, and ``len`` counts the whole epoch."""
        self.epoch = epoch
        self.start_batch = int(start_batch)

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

    def _chunks(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        for b in range(self.start_batch, len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            ctx = mp.get_context("fork")  # workers inherit the file lists; numpy only
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx, initializer=_init_worker,
                initargs=(self.dataset, ctx.Value("i", 0), self.seed + 7919))
        return self._pool

    def close(self) -> None:
        """Stop the worker pool, if one was started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _batches_mp(self) -> Iterator:
        """Batches from the worker pool in order, at most ``2 * num_workers
        + prefetch`` in flight."""
        pool = self._ensure_pool()
        window = 2 * self.num_workers + self.prefetch
        pending: deque = deque()
        try:
            for chunk in self._chunks():
                pending.append(pool.submit(_fetch_chunk, chunk))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()

    def _batches_prefetched(self) -> Iterator:
        """Batches built on a thread, ``prefetch`` ahead; the thread stops
        when the consumer does."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop, done, err = threading.Event(), object(), []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                for chunk in self._chunks():
                    if not put(_collate_chunk(self.dataset, chunk)):
                        return
            except Exception as e:  # raised again in the consumer
                err.append(e)
            put(done)

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not done:
                yield item
        finally:
            stop.set()
            thread.join()
        if err:
            raise err[0]

    def __iter__(self) -> Iterator:
        if self.num_workers > 0:
            return self._batches_mp()
        if self.prefetch > 0:
            return self._batches_prefetched()
        return (_collate_chunk(self.dataset, c) for c in self._chunks())
