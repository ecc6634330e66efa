"""Batch loader with background prefetch, framework-free.

Port of ``slim_switch_moe_vit_tpu/data/loader.py``: worker threads run the
host transform (crop + resize), and each batch is one contiguous uint8
array, ready for one host-to-device copy. The same batches in the same
order; unlike the JAX package's loader, which submits every batch of the
epoch at once, at most ``num_workers + prefetch`` batches are in flight,
and stopping early (``max_steps``) cancels the rest and ends the workers.
"""
from __future__ import annotations

import collections
import typing as typ
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class DataLoader:
    def __init__(self, dataset, sampler, batch_size: int,
                 drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _batches(self) -> typ.Iterator[typ.List[int]]:
        batch: typ.List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _fetch(self, indices: typ.List[int]):
        imgs, targets = [], []
        for i in indices:
            img, t = self.dataset[i]
            imgs.append(img)
            targets.append(t)
        return np.stack(imgs), np.asarray(targets, dtype=np.int64)

    def __iter__(self):
        if self.num_workers <= 1:
            for batch in self._batches():
                yield self._fetch(batch)
            return
        pool = ThreadPoolExecutor(self.num_workers)
        pending: typ.Deque = collections.deque()
        batches = self._batches()
        try:
            for batch in batches:
                pending.append(pool.submit(self._fetch, batch))
                if len(pending) >= self.num_workers + self.prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
            pool.shutdown(wait=True)
