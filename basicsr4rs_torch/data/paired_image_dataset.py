"""Paired LQ/GT image dataset (counterpart of
``basicsr4rs_tpu/data/paired_image_dataset.py``; reference:
basicsr/data/paired_image_dataset.py).

Folder mode for the val/test phases: each item is the LQ and GT images as
CHW float32 RGB tensors in [0, 1], with the GT cropped to scale x the LQ.
Training crops and augmentation, and the LMDB and meta-info-file modes,
come with the train path.
"""

from __future__ import annotations

import torch

from ..utils.color_util import bgr2ycbcr
from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.registry import DATASET_REGISTRY
from .data_util import paired_paths_from_folder


@DATASET_REGISTRY.register()
class PairedImageDataset:

    def __init__(self, opt):
        if opt['phase'] == 'train':
            raise NotImplementedError('PairedImageDataset: the train phase (random crop '
                                      'and augmentation) is not ported yet')
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        if io_backend_opt['type'] != 'disk' or opt.get('meta_info_file') is not None:
            raise NotImplementedError('PairedImageDataset: only folder mode on disk is '
                                      'ported yet')
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.paths = paired_paths_from_folder([opt['dataroot_lq'], opt['dataroot_gt']],
                                              ['lq', 'gt'], opt.get('filename_tmpl', '{}'))

    def __getitem__(self, index):
        scale = self.opt['scale']
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt = imfrombytes(self.file_client.get(gt_path, 'gt'), float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'), float32=True)

        y_only = self.opt.get('color') == 'y'
        if y_only:
            img_gt = bgr2ycbcr(img_gt, y_only=True)[..., None]
            img_lq = bgr2ycbcr(img_lq, y_only=True)[..., None]

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
