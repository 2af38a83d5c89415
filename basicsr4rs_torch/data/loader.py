"""Data loading (counterpart of ``basicsr4rs_tpu/data/loader.py``): the
rank-strided sampler, an order-preserving threaded loader, and the
prefetchers.

Datasets are map-style objects (``__len__`` / ``__getitem__`` returning
dicts of tensors and strings). Decoding and augmentation are cv2/numpy,
which release the GIL, so worker threads keep the input path off the
training step; items are yielded in sampler order whatever the worker
count. ``CUDAPrefetcher`` copies the next batch to the device on a side
stream while the current step runs.
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel import shard_batch


class EnlargedSampler:
    """Rank-strided sampler over a dataset virtually enlarged ``ratio``
    times, so that iteration-based training restarts epochs rarely. The
    permutation is numpy's, seeded by the epoch, exactly as in the JAX
    package: both draw the same indices."""

    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0, ratio: int = 1):
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = math.ceil(dataset_size * ratio / num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.epoch)
        indices = g.permutation(self.total_size) % self.dataset_size
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(indices.tolist())

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch


def default_collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack dict items into a dict batch: tensors and numbers stack into a
    leading batch dim, nested dicts collate recursively, the rest become
    lists."""
    batch: Dict[str, Any] = {}
    for key, value in items[0].items():
        vals = [it[key] for it in items]
        if torch.is_tensor(value):
            batch[key] = torch.stack(vals, dim=0)
        elif isinstance(value, np.ndarray):
            batch[key] = torch.from_numpy(np.stack(vals, axis=0))
        elif isinstance(value, dict):
            batch[key] = default_collate(vals)
        elif isinstance(value, (int, float, np.integer, np.floating)):
            batch[key] = torch.as_tensor(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Batches of ``batch_size`` items of ``dataset`` in the sampler's order
    (or in dataset order, shuffled per epoch with ``shuffle``). With
    ``num_workers`` > 0 a thread pool fetches up to ``prefetch_factor *
    num_workers`` items ahead."""

    def __init__(self, dataset, batch_size: int = 1, sampler: Optional[EnlargedSampler] = None,
                 shuffle: bool = False, num_workers: int = 0, drop_last: bool = False,
                 collate_fn=default_collate, prefetch_factor: int = 2,
                 seed: Optional[int] = None, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch_factor = max(prefetch_factor, 1)
        self.seed = seed
        self.pin_memory = pin_memory
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            g = np.random.default_rng(None if self.seed is None else self.seed + self._epoch)
            g.shuffle(indices)
        return indices

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _collate(self, items):
        batch = self.collate_fn(items)
        if self.pin_memory:
            batch = {k: v.pin_memory() if torch.is_tensor(v) else v for k, v in batch.items()}
        return batch

    def __iter__(self):
        indices = self._indices()
        if self.drop_last:
            indices = indices[:(len(indices) // self.batch_size) * self.batch_size]
        batches = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]

        if self.num_workers <= 0:
            for batch_idx in batches:
                yield self._collate([self.dataset[i] for i in batch_idx])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = iter(i for batch_idx in batches for i in batch_idx)
            futures = deque()

            def submit_next():
                idx = next(pending, None)
                if idx is not None:
                    futures.append(pool.submit(self.dataset.__getitem__, idx))

            for _ in range(self.prefetch_factor * self.num_workers):
                submit_next()
            for batch_idx in batches:
                items = []
                for _ in batch_idx:
                    items.append(futures.popleft().result())
                    submit_next()
                yield self._collate(items)


class CPUPrefetcher:
    """A loader as ``next()`` / ``reset()``; nothing is fetched ahead."""

    def __init__(self, loader: DataLoader):
        self.ori_loader = loader
        self.loader = iter(loader)

    def next(self):
        return next(self.loader, None)

    def reset(self):
        self.loader = iter(self.ori_loader)


class CUDAPrefetcher:
    """One batch ahead on the device: the copy of batch N+1 is enqueued on a
    side stream while the step on batch N runs (``prefetch_mode: cuda``;
    give the loader ``pin_memory`` so that the copy does not block)."""

    def __init__(self, loader: DataLoader, device: torch.device):
        self.ori_loader = loader
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.loader = iter(loader)
        self._preload()

    def _preload(self):
        self.batch = next(self.loader, None)
        if self.batch is None:
            return
        with torch.cuda.stream(self.stream):
            self.batch = shard_batch(self.batch, self.device)

    def next(self):
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        batch = self.batch
        if batch is not None:
            for v in batch.values():
                if torch.is_tensor(v):   # the step's stream now owns the memory
                    v.record_stream(torch.cuda.current_stream(self.device))
            self._preload()
        return batch

    def reset(self):
        self.loader = iter(self.ori_loader)
        self._preload()
