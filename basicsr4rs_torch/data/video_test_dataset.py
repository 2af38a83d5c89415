"""Video test datasets (counterpart of
``basicsr4rs_tpu/data/video_test_dataset.py``; reference:
basicsr/data/video_test_dataset.py).

``VideoTestDataset``: one item per frame of every clip, the window of
``num_frame`` LQ frames around it (padded at the clip's ends as ``padding``
says) and its GT frame. ``VideoRecurrentTestDataset``: one item per clip, all
its frames. Clips are the sub-folders of ``dataroot_lq`` / ``dataroot_gt``,
or those a ``meta_info_file`` lists; ``cache_data`` reads them all at
construction. Tensors are (T, C, H, W) / (C, H, W) float32 RGB in [0, 1]. The
Vimeo90K and DUF variants are not ported yet.
"""

from __future__ import annotations

import glob
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import generate_frame_indices, read_img_seq


@DATASET_REGISTRY.register()
class VideoTestDataset:

    def __init__(self, opt):
        self.opt = opt
        self.cache_data = opt.get('cache_data', False)
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [], 'idx': [], 'border': []}
        if opt.get('io_backend', {'type': 'disk'})['type'] == 'lmdb':
            raise ValueError('No need to use lmdb during validation/test.')

        get_root_logger().info(f'Generate data info for VideoTestDataset - {opt["name"]}')
        self.imgs_lq, self.imgs_gt = {}, {}
        if opt.get('meta_info_file'):
            with open(opt['meta_info_file'], 'r') as fin:
                subfolders = [line.split(' ')[0].strip() for line in fin if line.strip()]
            subfolders_lq = [osp.join(self.lq_root, key) for key in subfolders]
            subfolders_gt = [osp.join(self.gt_root, key) for key in subfolders]
        else:
            subfolders_lq = sorted(d for d in glob.glob(osp.join(self.lq_root, '*'))
                                   if osp.isdir(d))
            subfolders_gt = sorted(d for d in glob.glob(osp.join(self.gt_root, '*'))
                                   if osp.isdir(d))

        for subfolder_lq, subfolder_gt in zip(subfolders_lq, subfolders_gt):
            subfolder_name = osp.basename(subfolder_lq)
            img_paths_lq = sorted(scandir(subfolder_lq, full_path=True))
            img_paths_gt = sorted(scandir(subfolder_gt, full_path=True))
            max_idx = len(img_paths_lq)
            if max_idx != len(img_paths_gt):
                raise ValueError(f'Different number of images in lq ({max_idx}) and gt '
                                 f'folders ({len(img_paths_gt)})')

            self.data_info['lq_path'].extend(img_paths_lq)
            self.data_info['gt_path'].extend(img_paths_gt)
            self.data_info['folder'].extend([subfolder_name] * max_idx)
            self.data_info['idx'].extend(f'{i}/{max_idx}' for i in range(max_idx))
            border_l = [0] * max_idx
            for i in range(self.opt['num_frame'] // 2):
                border_l[i] = 1
                border_l[max_idx - i - 1] = 1
            self.data_info['border'].extend(border_l)

            if self.cache_data:
                self.imgs_lq[subfolder_name] = read_img_seq(img_paths_lq)
                self.imgs_gt[subfolder_name] = read_img_seq(img_paths_gt)
            else:
                self.imgs_lq[subfolder_name] = img_paths_lq
                self.imgs_gt[subfolder_name] = img_paths_gt

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = map(int, self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx, self.opt['num_frame'],
                                            padding=self.opt.get('padding', 'reflection'))
        if self.cache_data:
            imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq([self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]
        return {'lq': imgs_lq, 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index], 'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """One item per clip: all its LQ and GT frames. Requires ``cache_data``."""

    def __init__(self, opt):
        super().__init__(opt)
        if not self.cache_data:
            raise ValueError('cache_data must be true for VideoRecurrentTestDataset')
        self.folders = sorted(set(self.data_info['folder']))

    def __getitem__(self, index):
        folder = self.folders[index]
        return {'lq': self.imgs_lq[folder], 'gt': self.imgs_gt[folder], 'folder': folder}

    def __len__(self):
        return len(self.folders)
