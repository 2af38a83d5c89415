"""Data loader (counterpart of ``basicsr4rs_tpu/data/loader.py``).

Datasets are map-style objects (``__len__`` / ``__getitem__`` returning
dicts of tensors and strings); the loader yields collated batches in order.
Shuffling, worker threads, the rank-strided sampler and the host-to-device
prefetcher come with the train path.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch


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
    """Batches of ``batch_size`` consecutive items of ``dataset``."""

    def __init__(self, dataset, batch_size: int = 1, collate_fn=default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn

    def __len__(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    def __iter__(self):
        for start in range(0, len(self.dataset), self.batch_size):
            stop = min(start + self.batch_size, len(self.dataset))
            yield self.collate_fn([self.dataset[i] for i in range(start, stop)])
