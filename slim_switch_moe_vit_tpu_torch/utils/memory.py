"""Rehearsal store for continual learning, framework-free.

Port of ``slim_switch_moe_vit_tpu/utils/memory.py`` (a copy; behavioral
parity target: reference ``memory.py:5-58``). A fixed-capacity buffer of
examples (or of dataset indices when ``use_indices=True``) from earlier
tasks. Each ``add`` draws a random subset of the incoming batch, appends
while capacity remains, and once full overwrites uniformly random slots.
Storage is host-side numpy; replay batches take the normal input path to
the device.
"""
from __future__ import annotations

import typing as typ

import numpy as np


class RehearsalMemory:
    def __init__(self, max_size: int, input_shape: typ.Sequence[int],
                 output_shape: typ.Sequence[int], use_indices: bool = False,
                 seed: int = 0):
        self.max_size = max_size
        self.use_indices = use_indices
        self.size = 0
        self.rng = np.random.RandomState(seed)
        # Index mode stores int64 positions into an existing dataset; sample
        # mode stores the tensors themselves.
        x_shape, y_shape = ((), ()) if use_indices else (tuple(input_shape),
                                                         tuple(output_shape))
        dt = np.int64 if use_indices else np.float32
        self._batch = np.zeros((max_size, *x_shape), dtype=dt)
        self._labels = np.zeros((max_size, *y_shape), dtype=dt)

    def __len__(self) -> int:
        return self.size

    def add(self, batch: np.ndarray, labels: np.ndarray, num_samples: int):
        """Store ``num_samples`` random rows of ``batch``/``labels``.

        While the buffer has free slots they are filled in order; any overflow
        evicts uniformly random slots (which may include ones filled a moment
        ago — matching the reference, whose replacement indices span the whole
        buffer).
        """
        if len(batch) != len(labels):
            raise ValueError(
                f"batch/labels length mismatch: {len(batch)} vs {len(labels)}")
        if num_samples > len(batch):
            raise ValueError(
                f"asked to store {num_samples} of a {len(batch)}-row batch")

        picked = self.rng.permutation(len(batch))[:num_samples]
        n_append = min(num_samples, self.max_size - self.size)
        dest = np.arange(self.size, self.size + n_append)
        if n_append < num_samples:
            evicted = self.rng.permutation(self.max_size)
            dest = np.concatenate([dest, evicted[: num_samples - n_append]])
        # Duplicate destinations resolve last-write-wins, i.e. an eviction can
        # land on a slot appended in this same call — as in the reference.
        self._batch[dest] = np.asarray(batch)[picked]
        self._labels[dest] = np.asarray(labels)[picked]
        self.size = min(self.max_size, self.size + num_samples)

    @property
    def batch(self) -> np.ndarray:
        return self._batch[: self.size]

    @property
    def labels(self) -> np.ndarray:
        return self._labels[: self.size]
