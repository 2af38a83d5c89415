"""Paired LQ/GT image dataset (counterpart of
``basicsr4rs_tpu/data/paired_image_dataset.py``; reference:
basicsr/data/paired_image_dataset.py).

Each item is the LQ and GT images as CHW float32 RGB tensors in [0, 1],
paired by the keys of two ``.lmdb`` folders (``io_backend: lmdb``), from
the GT names of ``meta_info_file`` and ``filename_tmpl``, or by scanning the
two folders. The LMDB store is opened at the first item, so building the
dataset needs no ``lmdb``; reading an LMDB item without it raises
``ImportError``. The train phase takes a random aligned crop (``gt_size``)
and flips and rotates it, drawing from a generator seeded with
``manual_seed``; the val/test phases crop the GT to scale x the LQ.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.color_util import bgr2ycbcr
from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.registry import DATASET_REGISTRY
from .data_util import (paired_paths_from_folder, paired_paths_from_lmdb,
                        paired_paths_from_meta_info_file)
from .transforms import augment, paired_random_crop


@DATASET_REGISTRY.register()
class PairedImageDataset:

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        folders = [opt['dataroot_lq'], opt['dataroot_gt']]
        filename_tmpl = opt.get('filename_tmpl', '{}')
        if io_backend_opt['type'] == 'lmdb':
            io_backend_opt['db_paths'] = folders
            io_backend_opt['client_keys'] = ['lq', 'gt']
            self.paths = paired_paths_from_lmdb(folders, ['lq', 'gt'])
        elif opt.get('meta_info_file') is not None:
            self.paths = paired_paths_from_meta_info_file(folders, ['lq', 'gt'],
                                                          opt['meta_info_file'], filename_tmpl)
        else:
            self.paths = paired_paths_from_folder(folders, ['lq', 'gt'], filename_tmpl)
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)
        # per-item random stream, as in the JAX package: one generator, drawn
        # in item order (the loader fetches a batch's items in order)
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def __getitem__(self, index):
        scale = self.opt['scale']
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt = imfrombytes(self.file_client.get(gt_path, 'gt'), float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'), float32=True)

        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.opt['gt_size'], scale,
                                                gt_path, rng=self._rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get('use_hflip', False),
                                     self.opt.get('use_rot', False), rng=self._rng)

        y_only = self.opt.get('color') == 'y'
        if y_only:
            img_gt = bgr2ycbcr(img_gt, y_only=True)[..., None]
            img_lq = bgr2ycbcr(img_lq, y_only=True)[..., None]

        if self.opt['phase'] != 'train':
            img_gt = img_gt[0:img_lq.shape[0] * scale, 0:img_lq.shape[1] * scale, :]
        img_gt, img_lq = img2tensor([img_gt, img_lq], bgr2rgb=not y_only, float32=True)

        if self.mean is not None or self.std is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32).view(-1, 1, 1)
            std = torch.tensor(self.std, dtype=torch.float32).view(-1, 1, 1)
            img_lq = (img_lq - mean) / std
            img_gt = (img_gt - mean) / std

        return {'lq': img_lq, 'gt': img_gt, 'lq_path': lq_path, 'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
