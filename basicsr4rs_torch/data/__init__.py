"""Dataset/dataloader builders with auto-discovery (counterpart of
``basicsr4rs_tpu/data/__init__.py``; reference: basicsr/data/__init__.py)."""

from __future__ import annotations

import importlib
from copy import deepcopy
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .loader import DataLoader, default_collate

__all__ = ['build_dataset', 'build_dataloader', 'DataLoader', 'default_collate']

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


def build_dataloader(dataset, dataset_opt, num_gpu: int = 1, dist: bool = False):
    """The val/test loader: batch 1, in order. The train loader comes with
    the train path."""
    phase = dataset_opt['phase']
    if phase in ('val', 'test'):
        return DataLoader(dataset, batch_size=1)
    if phase == 'train':
        raise NotImplementedError('build_dataloader: the train loader is not ported yet')
    raise ValueError(f"Wrong dataset phase: {phase}. Supported ones are 'train', 'val' and 'test'.")
