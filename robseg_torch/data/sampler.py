"""Epoch-shuffled, iteration-based train batches and sequential eval
batches, in the port's layout: NCHW float32 images and int64 labels.

Port of ``robseg_tpu/data/sampler.py`` (reference
``semseg/datasets/distributed_sampler.py``): ``ShardedEpochSampler`` deals
each epoch's shuffle (``np.random.default_rng(seed + epoch)``, wrap-padded
to a multiple of ``num_shards``) out to the shards, and with
``num_hosts``/``host_id`` enumerates only this host's contiguous block of
shards; under data parallelism a rank is a host that feeds one shard
(``num_shards = num_hosts = world``, ``host_id = rank``), so its index sets
are the JAX package's for the same (shards, hosts, host).
``IterationBasedLoader`` yields exactly ``max_iters`` batches from
``start_iter`` on, the epoch seeding the shuffle and the dataset's
augmentation, the last partial batch of an epoch dropped.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np


class ShardedEpochSampler:
    """Deterministic epoch-seeded shuffling, wrap-padded to a multiple of
    ``num_shards``; shard s takes every num_shards-th index from s. Host
    ``host_id`` of ``num_hosts`` feeds the contiguous block of shards
    ``local_shards``: the hosts' index sets are disjoint and their union
    is the one-host global batch."""

    def __init__(self, dataset_len: int, num_shards: int = 1, *,
                 shuffle: bool = True, seed: int = 0, num_hosts: int = 1,
                 host_id: int = 0):
        if num_shards % num_hosts or not 0 <= host_id < num_hosts:
            raise ValueError(f"{num_shards} shards over {num_hosts} hosts, "
                             f"host {host_id}")
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_samples = int(math.ceil(dataset_len * 1.0 / num_shards))
        self.total_size = self.num_samples * num_shards

    def shard_indices(self, epoch: int, shard: int) -> np.ndarray:
        if self.shuffle:
            indices = np.random.default_rng(self.seed + epoch).permutation(
                self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        pad = self.total_size - len(indices)
        if pad:
            indices = np.concatenate([indices, indices[:pad]])
        return indices[shard:self.total_size:self.num_shards]

    @property
    def local_shards(self) -> range:
        """The contiguous block of shard ids this host feeds."""
        per_host = self.num_shards // self.num_hosts
        return range(self.host_id * per_host, (self.host_id + 1) * per_host)

    def global_batch_indices(self, epoch: int, batch_per_shard: int
                             ) -> Iterator[np.ndarray]:
        """This host's slice of each global batch's indices (with one host
        the whole batch), its first shard's first; the last partial batch
        is dropped."""
        per_shard = [self.shard_indices(epoch, s) for s in self.local_shards]
        for b in range(self.num_samples // batch_per_shard):
            sl = slice(b * batch_per_shard, (b + 1) * batch_per_shard)
            yield np.concatenate([p[sl] for p in per_shard])


def _stack(items):
    imgs = np.stack([img for img, _ in items]).transpose(0, 3, 1, 2)
    masks = np.stack([m for _, m in items]).astype(np.int64)
    return np.ascontiguousarray(imgs), masks


class IterationBasedLoader:
    """``(images (B, 3, H, W), labels (B, H, W))`` numpy batches for
    exactly ``max_iters`` iterations (one epoch when None); ``batch_size``
    images a shard, for this host's shards (see ``ShardedEpochSampler``)."""

    def __init__(self, dataset, *, batch_size: int,
                 max_iters: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, start_iter: int = 0, num_shards: int = 1,
                 num_hosts: int = 1, host_id: int = 0):
        self.dataset = dataset
        self.sampler = ShardedEpochSampler(len(dataset), num_shards,
                                           shuffle=shuffle, seed=seed,
                                           num_hosts=num_hosts,
                                           host_id=host_id)
        self.batch_size = batch_size
        self.max_iters = max_iters
        self.start_iter = start_iter
        self.iters_per_epoch = self.sampler.num_samples // batch_size

    def __iter__(self):
        it = self.start_iter
        epoch = it // max(self.iters_per_epoch, 1)
        while self.max_iters is None or it < self.max_iters:
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(epoch)
            skip = it - epoch * self.iters_per_epoch
            for bi, idx in enumerate(self.sampler.global_batch_indices(
                    epoch, self.batch_size)):
                if bi < skip:
                    continue
                yield _stack([self.dataset[int(i)] for i in idx])
                it += 1
                if self.max_iters is not None and it >= self.max_iters:
                    return
            epoch += 1
            if self.max_iters is None:
                return


def simple_eval_loader(dataset, batch_size: int, n_batches: int = -1):
    """Unshuffled ``(images (B,3,H,W), labels (B,H,W))`` numpy batches; the
    last batch may be partial; stops after ``n_batches`` when positive."""
    n = len(dataset)
    out = 0
    for s in range(0, n, batch_size):
        yield _stack([dataset[i] for i in range(s, min(s + batch_size, n))])
        out += 1
        if out == n_batches:
            return
