"""Samplers (counterpart of ``oneshotdet_tpu/data/samplers.py``).

  - DistributedSampler: rank slice of an epoch-seeded permutation; the port
    runs one replica (``num_replicas=1``), as its loader does;
  - iterate_batches / iteration_based_batches: finite and iteration-based
    batch streams (the latter cycles epochs from ``start_iter``);
  - orientation grouping: each batch holds landscape (w >= h) or portrait
    images only, so it pads into one query bucket.
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    """Deterministic rank slice of an epoch permutation."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            indices = g.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        # pad to make evenly divisible (distributed.py:47-49)
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples


def iterate_batches(sampler, batch_size: int, drop_last: bool = True):
    batch = []
    for idx in sampler:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


def iteration_based_batches(sampler, batch_size: int, num_iterations: int,
                            start_iter: int = 0):
    """Infinite epoch-cycling batch stream (iteration_based_batch_sampler.py)."""
    iteration = start_iter
    epoch = 0
    while iteration < num_iterations:
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        for batch in iterate_batches(sampler, batch_size, drop_last=True):
            if iteration >= num_iterations:
                return
            iteration += 1
            yield batch
        epoch += 1


def group_indices_by_orientation(dataset, indices):
    """Stable partition into landscape (w>=h) and portrait streams."""
    landscape, portrait = [], []
    for i in indices:
        info, _ = dataset.get_img_info(i)
        (landscape if info["width"] >= info["height"] else portrait).append(i)
    return landscape, portrait


def grouped_batches(dataset, sampler, batch_size: int, drop_last: bool = True):
    """Aspect-ratio-grouped batching (GroupedBatchSampler analog,
    grouped_batch_sampler.py:9): each batch contains only one orientation so
    the collator pads into one stable resolution bucket (one XLA program per
    orientation instead of per batch shape)."""
    buffers = {True: [], False: []}
    for idx in sampler:
        info, _ = dataset.get_img_info(idx)
        key = info["width"] >= info["height"]
        buffers[key].append(idx)
        if len(buffers[key]) == batch_size:
            yield buffers[key]
            buffers[key] = []
    if not drop_last:
        for buf in buffers.values():
            if buf:
                yield buf


def grouped_iteration_batches(dataset, sampler, batch_size: int,
                              num_iterations: int, start_iter: int = 0):
    """Infinite orientation-grouped stream with start_iter resume."""
    iteration = start_iter
    epoch = 0
    while iteration < num_iterations:
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        for batch in grouped_batches(dataset, sampler, batch_size, drop_last=True):
            if iteration >= num_iterations:
                return
            iteration += 1
            yield batch
        epoch += 1
