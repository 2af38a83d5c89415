"""Vimeo90K training datasets (counterpart of
``basicsr4rs_tpu/data/vimeo90k_dataset.py``; reference:
basicsr/data/vimeo90k_dataset.py).

``Vimeo90KDataset``: ``num_frame`` LQ frames of a septuplet centred on its
fourth frame ``im4``, and ``im4``'s GT (EDVR). ``Vimeo90KRecurrentDataset``:
all seven LQ frames with their GTs (BasicVSR, IconVSR); ``flip_sequence``
doubles them to 14 by appending the clip reversed. Keys ``clip/seq`` come
from the first word of each line of ``meta_info_file``; frames are
``<root>/<clip>/<seq>/im<i>.png``. Reversal, crop and flips are drawn from
one generator seeded with ``manual_seed``, in the JAX package's order, so
the same seed gives the same items in both packages. Tensors are (T, C, H, W)
/ (C, H, W) float32 RGB in [0, 1]. The LMDB backend stays behind the
``lmdb`` import, as in the JAX package.
"""

from __future__ import annotations

from os import path as osp

import numpy as np
import torch

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.registry import DATASET_REGISTRY
from .transforms import augment, paired_random_crop


@DATASET_REGISTRY.register()
class Vimeo90KDataset:

    def __init__(self, opt):
        self.opt = opt
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        with open(opt['meta_info_file'], 'r') as fin:
            self.keys = [line.split(' ')[0].strip() for line in fin if line.strip()]

        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.is_lmdb = io_backend_opt['type'] == 'lmdb'
        if self.is_lmdb:
            io_backend_opt['db_paths'] = [self.lq_root, self.gt_root]
            io_backend_opt['client_keys'] = ['lq', 'gt']
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)

        # the neighbours centred on im4
        self.neighbor_list = [i + (9 - opt['num_frame']) // 2 for i in range(opt['num_frame'])]
        self.random_reverse = opt.get('random_reverse', False)
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def _read(self, clip, seq, frame, client_key):
        root = self.gt_root if client_key == 'gt' else self.lq_root
        path = f'{clip}/{seq}/im{frame}' if self.is_lmdb else osp.join(root, clip, seq,
                                                                       f'im{frame}.png')
        return imfrombytes(self.file_client.get(path, client_key), float32=True), path

    def __getitem__(self, index):
        key = self.keys[index]
        clip, seq = key.split('/')
        neighbor_list = list(self.neighbor_list)
        if self.random_reverse and self._rng.random() < 0.5:
            neighbor_list.reverse()

        img_gt, gt_path = self._read(clip, seq, 4, 'gt')
        if self.is_lmdb:
            gt_path = f'{key}/im4'
        img_lqs = [self._read(clip, seq, i, 'lq')[0] for i in neighbor_list]
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, self.opt['gt_size'],
                                             self.opt['scale'], gt_path, rng=self._rng)
        img_lqs.append(img_gt)
        img_results = augment(img_lqs, self.opt.get('use_hflip', False),
                              self.opt.get('use_rot', False), rng=self._rng)
        img_results = img2tensor(img_results)
        return {'lq': torch.stack(img_results[:-1], dim=0), 'gt': img_results[-1], 'key': key}

    def __len__(self):
        return len(self.keys)


@DATASET_REGISTRY.register()
class Vimeo90KRecurrentDataset(Vimeo90KDataset):

    def __init__(self, opt):
        super().__init__(opt)
        self.flip_sequence = opt.get('flip_sequence', False)
        self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]

    def __getitem__(self, index):
        key = self.keys[index]
        clip, seq = key.split('/')
        img_lqs = [self._read(clip, seq, i, 'lq')[0] for i in self.neighbor_list]
        img_gts = [self._read(clip, seq, i, 'gt')[0] for i in self.neighbor_list]
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, self.opt['gt_size'],
                                              self.opt['scale'], clip, rng=self._rng)
        img_lqs.extend(img_gts)
        img_results = augment(img_lqs, self.opt.get('use_hflip', False),
                              self.opt.get('use_rot', False), rng=self._rng)
        img_results = img2tensor(img_results)
        img_lqs = torch.stack(img_results[:7], dim=0)
        img_gts = torch.stack(img_results[7:], dim=0)
        if self.flip_sequence:   # 7 frames to 14, the second half the first reversed
            img_lqs = torch.cat([img_lqs, img_lqs.flip(0)], dim=0)
            img_gts = torch.cat([img_gts, img_gts.flip(0)], dim=0)
        return {'lq': img_lqs, 'gt': img_gts, 'key': key}
