"""Video test datasets (counterpart of
``basicsr4rs_tpu/data/video_test_dataset.py``; reference:
basicsr/data/video_test_dataset.py).

``VideoTestDataset``: one item per frame of every clip, the window of
``num_frame`` LQ frames around it (padded at the clip's ends as ``padding``
says) and its GT frame. ``VideoRecurrentTestDataset``: one item per clip, all
its frames. Clips are the sub-folders of ``dataroot_lq`` / ``dataroot_gt``,
or those a ``meta_info_file`` lists; ``cache_data`` reads them all at
construction. ``VideoTestVimeo90KDataset``: one item per septuplet of a
meta-info file, ``num_frame`` LQ frames centred on ``im4`` and its GT.
``VideoTestDUFDataset``: ``VideoTestDataset`` whose LQ window, with
``use_duf_downsampling``, is made from the GT frames by DUF's Gaussian
downsampling (``data_util.duf_downsample``) and whose GT is cropped to a
multiple of ``scale``. Tensors are (T, C, H, W) / (C, H, W) float32 RGB in
[0, 1].
"""

from __future__ import annotations

import glob
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import duf_downsample, generate_frame_indices, read_img_seq


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
class VideoTestVimeo90KDataset:

    def __init__(self, opt):
        self.opt = opt
        if opt.get('cache_data', False):
            raise NotImplementedError('cache_data in Vimeo90K-Test dataset is not implemented.')
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [], 'idx': [], 'border': []}
        neighbor_list = [i + (9 - opt['num_frame']) // 2 for i in range(opt['num_frame'])]
        with open(opt['meta_info_file'], 'r') as fin:
            subfolders = [line.split(' ')[0].strip() for line in fin if line.strip()]
        for idx, subfolder in enumerate(subfolders):
            self.data_info['gt_path'].append(osp.join(self.gt_root, subfolder, 'im4.png'))
            self.data_info['lq_path'].append(
                [osp.join(self.lq_root, subfolder, f'im{i}.png') for i in neighbor_list])
            self.data_info['folder'].append('vimeo90k')
            self.data_info['idx'].append(f'{idx}/{len(subfolders)}')
            self.data_info['border'].append(0)

    def __getitem__(self, index):
        lq_path = self.data_info['lq_path'][index]
        return {'lq': read_img_seq(lq_path),
                'gt': read_img_seq([self.data_info['gt_path'][index]])[0],
                'folder': self.data_info['folder'][index], 'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': lq_path[self.opt['num_frame'] // 2]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = map(int, self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx, self.opt['num_frame'],
                                            padding=self.opt.get('padding', 'reflection'))
        scale = self.opt['scale']
        duf = self.opt.get('use_duf_downsampling', False)
        if self.cache_data:
            if duf:
                imgs_lq = duf_downsample(self.imgs_gt[folder][select_idx], kernel_size=13,
                                         scale=scale)
            else:
                imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            if duf:
                imgs_lq = duf_downsample(
                    read_img_seq([self.imgs_gt[folder][i] for i in select_idx],
                                 require_mod_crop=True, scale=scale), kernel_size=13, scale=scale)
            else:
                imgs_lq = read_img_seq([self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]], require_mod_crop=True,
                                  scale=scale)[0]
        return {'lq': imgs_lq.float(), 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index], 'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}


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
