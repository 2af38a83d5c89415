"""LQ-only dataset for inference without ground truth (counterpart of
``basicsr4rs_tpu/data/single_image_dataset.py``; reference:
basicsr/data/single_image_dataset.py).

Each item is an LQ image as a CHW float32 tensor in [0, 1] (RGB, or the Y
channel with ``color: y``), normalised by ``mean`` and ``std`` when given,
and its path. The images are the keys of an ``.lmdb`` folder (``io_backend:
lmdb``, opened at the first item: reading one without ``lmdb`` raises
``ImportError``), the ones a ``meta_info_file`` lists, or every file of
``dataroot_lq``.
"""

from __future__ import annotations

from os import path as osp

import torch

from ..utils.color_util import bgr2ycbcr
from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import paths_from_lmdb


@DATASET_REGISTRY.register()
class SingleImageDataset:

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.lq_folder = opt['dataroot_lq']
        if io_backend_opt['type'] == 'lmdb':
            io_backend_opt['db_paths'] = [self.lq_folder]
            io_backend_opt['client_keys'] = ['lq']
            self.paths = paths_from_lmdb(self.lq_folder)
        elif opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file'], 'r') as fin:
                self.paths = [osp.join(self.lq_folder, line.rstrip().split(' ')[0])
                              for line in fin]
        else:
            self.paths = sorted(scandir(self.lq_folder, full_path=True))
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)

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
