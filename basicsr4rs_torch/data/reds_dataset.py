"""REDS training datasets (counterpart of
``basicsr4rs_tpu/data/reds_dataset.py``; reference:
basicsr/data/reds_dataset.py).

``REDSDataset``: a key frame with ``num_frame // 2`` neighbours on each side
and the key frame's GT (EDVR). ``REDSRecurrentDataset``: ``num_frame``
consecutive frames with their GTs (BasicVSR++). Keys come from a meta-info
file with lines ``clip frames (h,w,c)``; the validation clips
(``val_partition``) are left out. Temporal interval, reversal, crop and flips
are drawn from one generator seeded with ``manual_seed``, in the JAX
package's order, so the same seed gives the same items in both packages.
Frames are files ``<root>/<clip>/<frame:08d>.png``, or with ``io_backend:
lmdb`` the keys ``<clip>/<frame:08d>`` of the ``.lmdb`` roots, opened at the
first item (reading one without ``lmdb`` raises ``ImportError``).
``dataroot_flow`` is accepted and, as in the JAX package, read by nothing:
in LMDB mode ``REDSDataset`` opens it as a third client, ``flow``. Tensors
are (T, C, H, W) / (C, H, W) float32 RGB in [0, 1].
"""

from __future__ import annotations

from os import path as osp

import numpy as np
import torch

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.registry import DATASET_REGISTRY
from .transforms import augment, paired_random_crop


class _REDSBase:

    def __init__(self, opt, flow_root=None):
        self.opt = opt
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.num_frame = opt['num_frame']
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.is_lmdb = io_backend_opt['type'] == 'lmdb'
        if self.is_lmdb:
            io_backend_opt['db_paths'] = [self.lq_root, self.gt_root]
            io_backend_opt['client_keys'] = ['lq', 'gt']
            if flow_root is not None:
                io_backend_opt['db_paths'].append(flow_root)
                io_backend_opt['client_keys'].append('flow')
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)

        self.keys = []
        self.frame_num = {}
        with open(opt['meta_info_file'], 'r') as fin:
            for line in fin:
                if not line.strip():
                    continue
                folder, frame_num, _ = line.split(' ')
                self.frame_num[folder] = int(frame_num)
                self.keys.extend(f'{folder}/{i:08d}' for i in range(int(frame_num)))

        val_partition = opt.get('val_partition', 'REDS4')
        if val_partition == 'REDS4':
            val_clips = ['000', '011', '015', '020']
        elif val_partition == 'official':
            val_clips = [f'{v:03d}' for v in range(240, 270)]
        else:
            raise ValueError(f'Wrong validation partition {val_partition}. '
                             "Supported ones are ['official', 'REDS4'].")
        keep_val = opt.get('test_mode', False)
        self.keys = [v for v in self.keys if (v.split('/')[0] in val_clips) == keep_val]

        self.interval_list = opt.get('interval_list', [1])
        self.random_reverse = opt.get('random_reverse', False)
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def _path(self, root, clip_name, frame):
        if self.is_lmdb:
            return f'{clip_name}/{frame:08d}'
        return osp.join(root, clip_name, f'{frame:08d}.png')

    def _read(self, root, clip_name, frame, client_key):
        path = self._path(root, clip_name, frame)
        return imfrombytes(self.file_client.get(path, client_key), float32=True)

    def __len__(self):
        return len(self.keys)


@DATASET_REGISTRY.register()
class REDSDataset(_REDSBase):

    def __init__(self, opt):
        if opt['num_frame'] % 2 != 1:
            raise ValueError(f"num_frame should be odd number, but got {opt['num_frame']}")
        super().__init__(opt, opt.get('dataroot_flow'))
        self.num_half_frames = opt['num_frame'] // 2

    def __getitem__(self, index):
        key = self.keys[index]
        clip_name, frame_name = key.split('/')
        center_frame_idx = int(frame_name)

        # a random interval, and a window moved inside the clip
        total = self.frame_num[clip_name]
        interval = int(self._rng.choice(self.interval_list))
        half = self.num_half_frames * interval
        while center_frame_idx - half < 0 or center_frame_idx + half > total - 1:
            center_frame_idx = int(self._rng.integers(0, total))
        neighbor_list = list(range(center_frame_idx - half, center_frame_idx + half + 1, interval))
        if self.random_reverse and self._rng.random() < 0.5:
            neighbor_list.reverse()

        img_gt = self._read(self.gt_root, clip_name, center_frame_idx, 'gt')
        img_lqs = [self._read(self.lq_root, clip_name, i, 'lq') for i in neighbor_list]
        gt_path = self._path(self.gt_root, clip_name, center_frame_idx)
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, self.opt['gt_size'],
                                             self.opt['scale'], gt_path, rng=self._rng)
        img_lqs.append(img_gt)
        img_results = augment(img_lqs, self.opt.get('use_hflip', False),
                              self.opt.get('use_rot', False), rng=self._rng)
        img_results = img2tensor(img_results)
        return {'lq': torch.stack(img_results[:-1], dim=0), 'gt': img_results[-1], 'key': key}


@DATASET_REGISTRY.register()
class REDSRecurrentDataset(_REDSBase):

    def __getitem__(self, index):
        key = self.keys[index]
        clip_name, frame_name = key.split('/')

        total = self.frame_num[clip_name]
        interval = int(self._rng.choice(self.interval_list))
        start_frame_idx = int(frame_name)
        if start_frame_idx > total - self.num_frame * interval:
            start_frame_idx = int(self._rng.integers(0, total - self.num_frame * interval + 1))
        neighbor_list = list(range(start_frame_idx, start_frame_idx + self.num_frame * interval,
                                   interval))
        if self.random_reverse and self._rng.random() < 0.5:
            neighbor_list.reverse()

        img_lqs = [self._read(self.lq_root, clip_name, i, 'lq') for i in neighbor_list]
        img_gts = [self._read(self.gt_root, clip_name, i, 'gt') for i in neighbor_list]
        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, self.opt['gt_size'],
                                              self.opt['scale'], clip_name, rng=self._rng)
        img_lqs.extend(img_gts)
        img_results = augment(img_lqs, self.opt.get('use_hflip', False),
                              self.opt.get('use_rot', False), rng=self._rng)
        img_results = img2tensor(img_results)
        return {'lq': torch.stack(img_results[:self.num_frame], dim=0),
                'gt': torch.stack(img_results[self.num_frame:], dim=0), 'key': key}
