"""Dataset/dataloader builders with auto-discovery (counterpart of
``basicsr4rs_tpu/data/__init__.py``; reference: basicsr/data/__init__.py)."""

from __future__ import annotations

import importlib
from copy import deepcopy
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .loader import (CPUPrefetcher, CUDAPrefetcher, DataLoader, EnlargedSampler,
                     default_collate)

__all__ = ['build_dataset', 'build_dataloader', 'DataLoader', 'default_collate',
           'EnlargedSampler', 'CPUPrefetcher', 'CUDAPrefetcher']

# import every '*_dataset.py' so that its registry decorators run
_data_folder = osp.dirname(osp.abspath(__file__))
_dataset_modules = [importlib.import_module(f'basicsr4rs_torch.data.{osp.splitext(v)[0]}')
                    for v in sorted(scandir(_data_folder)) if v.endswith('_dataset.py')]


def build_dataset(dataset_opt):
    """Instantiate a dataset by its ``type`` key."""
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)
    get_root_logger().info(f'Dataset [{dataset.__class__.__name__}] - '
                           f'{dataset_opt["name"]} is built.')
    return dataset


def build_dataloader(dataset, dataset_opt, num_gpu: int = 1, dist: bool = False,
                     sampler=None, seed=None):
    """The train loader (``batch_size_per_gpu`` items per device of this
    process, worker threads, the given sampler, incomplete batches
    dropped) or the val/test loader (batch 1, in order). Under a launcher
    (``dist``) a process is one rank on one card: its batch is
    ``batch_size_per_gpu`` and its workers ``num_worker_per_gpu``, so the
    global batch is ``batch_size_per_gpu x world_size``, the JAX package's
    one-process ``batch_size_per_gpu x device count``."""
    phase = dataset_opt['phase']
    if phase == 'train':
        multiplier = 1 if dist else max(num_gpu, 1)
        prefetch_cuda = dataset_opt.get('prefetch_mode') == 'cuda'
        return DataLoader(dataset, batch_size=dataset_opt['batch_size_per_gpu'] * multiplier,
                          sampler=sampler,
                          shuffle=sampler is None and dataset_opt.get('use_shuffle', True),
                          num_workers=dataset_opt.get('num_worker_per_gpu', 0) * multiplier,
                          drop_last=True, seed=seed,
                          pin_memory=dataset_opt.get('pin_memory', prefetch_cuda))
    if phase in ('val', 'test'):
        return DataLoader(dataset, batch_size=1)
    raise ValueError(f"Wrong dataset phase: {phase}. Supported ones are 'train', 'val' and 'test'.")
