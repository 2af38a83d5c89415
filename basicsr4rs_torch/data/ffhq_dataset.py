"""FFHQ for StyleGAN2 (counterpart of ``basicsr4rs_tpu/data/ffhq_dataset.py``;
reference: basicsr/data/ffhq_dataset.py).

Each item is a GT image as a CHW float32 RGB tensor, flipped horizontally
at random (``use_hflip``, from a generator seeded with ``manual_seed``),
then normalised by ``mean`` and ``std`` (0.5 each: [-1, 1]), and its path.
Folder mode reads every file of ``dataroot_gt``; ``io_backend: lmdb``
reads the keys of its ``meta_info.txt`` through the LMDB backend, which
needs the ``lmdb`` package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import paths_from_lmdb
from .transforms import augment


@DATASET_REGISTRY.register()
class FFHQDataset:

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.gt_folder = opt['dataroot_gt']
        self.mean = torch.tensor(opt.get('mean', [0.5] * 3), dtype=torch.float32).view(-1, 1, 1)
        self.std = torch.tensor(opt.get('std', [0.5] * 3), dtype=torch.float32).view(-1, 1, 1)
        if io_backend_opt['type'] == 'lmdb':
            io_backend_opt['db_paths'] = self.gt_folder
            self.paths = paths_from_lmdb(self.gt_folder)
        else:
            self.paths = sorted(scandir(self.gt_folder, full_path=True))
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def __getitem__(self, index):
        gt_path = self.paths[index]
        img_gt = imfrombytes(self.file_client.get(gt_path), float32=True)
        img_gt = augment(img_gt, hflip=self.opt.get('use_hflip', True), rotation=False,
                         rng=self._rng)
        img_gt = img2tensor(img_gt, bgr2rgb=True, float32=True)
        return {'gt': (img_gt - self.mean) / self.std, 'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
