"""Samplers, framework-free: the repeated-augmentation sampler and plain
distributed / sequential samplers.

Port of ``slim_switch_moe_vit_tpu/data/samplers.py`` (a copy). Samplers
produce index sequences; the loader makes the batches. A "replica" is a
data-parallel shard.
"""
from __future__ import annotations

import math

import numpy as np


class RASampler:
    """Repeated-augmentation sampler: every sample appears ``num_repeats``
    times so different augmented copies land on different replicas
    (reference samplers.py:37-69, including the floor(len/256*256) truncation)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, num_repeats: int = 3):
        assert num_repeats >= 1
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_repeats = num_repeats
        self.shuffle = shuffle
        self.epoch = 0
        self.num_samples = int(
            math.ceil(dataset_len * num_repeats / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.num_selected_samples = int(
            math.floor(dataset_len // 256 * 256 / num_replicas))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_selected_samples

    def __iter__(self):
        if self.shuffle:
            g = np.random.RandomState(self.epoch)
            indices = g.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        indices = np.repeat(indices, self.num_repeats).tolist()
        padding = self.total_size - len(indices)
        if padding > 0:
            indices += indices[:padding]
        assert len(indices) == self.total_size
        indices = indices[self.rank:self.total_size:self.num_replicas]
        assert len(indices) == self.num_samples
        return iter(indices[: self.num_selected_samples])


class DistributedSampler:
    """torch DistributedSampler equivalent (reference main.py:761-770)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        if self.shuffle:
            g = np.random.RandomState(self.epoch)
            indices = g.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank:self.total_size:self.num_replicas])


class SequentialSampler:
    def __init__(self, dataset_len: int):
        self.dataset_len = dataset_len

    def set_epoch(self, epoch: int):
        pass

    def __len__(self):
        return self.dataset_len

    def __iter__(self):
        return iter(range(self.dataset_len))
