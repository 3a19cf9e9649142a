"""Data loading (port of ``deepspeed_tpu/runtime/dataloader.py``):
``RepeatingLoader``, ``DeepSpeedDataLoader`` and ``ArrayDataset``.

The loader yields batches as stacked numpy arrays (one process feeds
the card); the engine moves a batch to the card in one copy. On one
card the loader's data-parallel world is 1 and its rank 0, which is
what it takes unless told otherwise.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


class RepeatingLoader:
    """Wrap an iterable to restart on StopIteration. ``fetch_wait_s``
    accumulates the host wall spent inside ``__next__``."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self.fetch_wait_s = 0.0

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        t0 = time.perf_counter()
        try:
            try:
                return next(self.data_iter)
            except StopIteration:
                self.data_iter = iter(self.loader)
                return next(self.data_iter)
        finally:
            self.fetch_wait_s += time.perf_counter() - t0

    def cumulative_fetch_wait_s(self) -> float:
        return self.fetch_wait_s


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (arrays / tuples / dicts of arrays)."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batched, optionally shuffled loader; each data-parallel rank takes
    an interleaved shard of the dataset (DistributedSampler
    semantics)."""

    def __init__(self, dataset: Any, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 data_parallel_world_size: int = 1,
                 data_parallel_rank: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.dp_world = data_parallel_world_size
        self.dp_rank = data_parallel_rank
        self.fetch_wait_s = 0.0
        self._len = self._shard_len() // batch_size if drop_last else \
            -(-self._shard_len() // batch_size)

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return n // self.dp_world if self.drop_last else \
            len(range(self.dp_rank, n, self.dp_world))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[Any]:
        order = np.arange(len(self.dataset))
        epoch = self.epoch
        self.epoch += 1          # each fresh iterator is a new epoch
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        shard = order[self.dp_rank::self.dp_world]
        usable = (len(shard) // self.batch_size) * self.batch_size \
            if self.drop_last else len(shard)
        for start in range(0, usable, self.batch_size):
            t0 = time.perf_counter()
            idxs = shard[start:start + self.batch_size]
            batch = self.collate_fn([self.dataset[int(i)] for i in idxs])
            self.fetch_wait_s += time.perf_counter() - t0
            yield batch

    def cumulative_fetch_wait_s(self) -> float:
        return self.fetch_wait_s


class ArrayDataset:
    """Tuple-of-arrays dataset: sample i = (arr[i] for each array)."""

    def __init__(self, *arrays: np.ndarray):
        assert arrays and all(len(a) == len(arrays[0]) for a in arrays)
        self.arrays = [np.asarray(a) for a in arrays]

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, i: int):
        if len(self.arrays) == 1:
            return self.arrays[0][i]
        return tuple(a[i] for a in self.arrays)


__all__ = ["RepeatingLoader", "DeepSpeedDataLoader", "ArrayDataset",
           "default_collate"]
