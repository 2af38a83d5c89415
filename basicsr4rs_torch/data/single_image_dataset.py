"""LQ-only dataset for inference without ground truth (counterpart of
``basicsr4rs_tpu/data/single_image_dataset.py``; reference:
basicsr/data/single_image_dataset.py).

Each item is an LQ image as a CHW float32 tensor in [0, 1] (RGB, or the Y
channel with ``color: y``), normalised by ``mean`` and ``std`` when given,
and its path. The images are every file of ``dataroot_lq`` (folder mode) or
the ones a ``meta_info_file`` lists; the LMDB mode is not ported yet.
"""

from __future__ import annotations

from os import path as osp

import torch

from ..utils.color_util import bgr2ycbcr
from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SingleImageDataset:

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        if io_backend_opt['type'] != 'disk':
            raise NotImplementedError('SingleImageDataset: only images on disk are ported yet')
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.lq_folder = opt['dataroot_lq']
        if opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file'], 'r') as fin:
                self.paths = [osp.join(self.lq_folder, line.rstrip().split(' ')[0])
                              for line in fin]
        else:
            self.paths = sorted(scandir(self.lq_folder, full_path=True))

    def __getitem__(self, index):
        lq_path = self.paths[index]
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'), float32=True)
        y_only = self.opt.get('color') == 'y'
        if y_only:
            img_lq = bgr2ycbcr(img_lq, y_only=True)[..., None]
        img_lq = img2tensor(img_lq, bgr2rgb=not y_only, float32=True)
        if self.mean is not None or self.std is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32).view(-1, 1, 1)
            std = torch.tensor(self.std, dtype=torch.float32).view(-1, 1, 1)
            img_lq = (img_lq - mean) / std
        return {'lq': img_lq, 'lq_path': lq_path}

    def __len__(self):
        return len(self.paths)
