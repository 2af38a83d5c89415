"""Real-ESRGAN's datasets (counterpart of
``basicsr4rs_tpu/data/realesrgan_dataset.py``; reference:
basicsr/data/realesrgan_dataset.py, realesrgan_paired_dataset.py).

``RealESRGANDataset`` gives GT crops and, for each, the two blur kernels
and the final sinc (or pulse) kernel of the second-order degradation, all
padded to 21 x 21 so that a batch stacks; the model degrades the batch on
its device. Its draws (flip, crop, kernels; the substitute index after a
read error) come from one ``np.random.RandomState(manual_seed)`` in the JAX
package's order, so that it gives the JAX package's items bit for bit when
items are read one at a time. The port's loader runs its workers as
threads over this one object: each item takes its draws as one block under
a lock, so no two workers repeat a draw, but with more than one worker the
block an item gets follows the threads' timing.
"""

from __future__ import annotations

import math
import os
import threading
import time

import cv2
import numpy as np
import torch

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import paired_paths_from_folder
from .degradations import circular_lowpass_kernel, random_mixed_kernels
from .transforms import augment, paired_random_crop

KERNEL_SIZE = 21   # every kernel is padded to this


@DATASET_REGISTRY.register()
class RealESRGANDataset:
    """GT images from ``meta_info`` (one relative path a line) or the folder
    ``dataroot_gt``; each item is flipped (``use_hflip``, ``use_rot``),
    reflect-padded or randomly cropped to ``crop_pad_size`` (400), and
    carries ``kernel1``, ``kernel2`` and ``sinc_kernel`` (21 x 21 float32)."""

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)

        if opt.get('meta_info') is not None:
            with open(opt['meta_info']) as fin:
                paths = [line.strip().split(' ')[0] for line in fin]
            self.paths = [os.path.join(opt['dataroot_gt'], v) for v in paths]
        else:
            self.paths = sorted(scandir(opt['dataroot_gt'], full_path=True))

        self.kernel_range = [2 * v + 1 for v in range(3, 11)]  # 7..21
        self.pulse_tensor = np.zeros((KERNEL_SIZE, KERNEL_SIZE), np.float32)
        self.pulse_tensor[KERNEL_SIZE // 2, KERNEL_SIZE // 2] = 1.

        self._rng = np.random.RandomState(opt.get('manual_seed'))
        self._rng_lock = threading.Lock()

    def _sample_kernel(self, suffix):
        """Kernel 1 (``suffix`` '') or 2 ('2'): a sinc with probability
        ``sinc_prob<suffix>``, else one of the mixture, zero-padded to 21."""
        o = self.opt
        kernel_size = int(self._rng.choice(self.kernel_range))
        if self._rng.uniform() < o['sinc_prob' + suffix]:
            omega_c = (self._rng.uniform(np.pi / 3, np.pi) if kernel_size < 13
                       else self._rng.uniform(np.pi / 5, np.pi))
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=False)
        else:
            sigma = o['blur_sigma' + suffix]
            kernel = random_mixed_kernels(o['kernel_list' + suffix], o['kernel_prob' + suffix],
                                          kernel_size, sigma, sigma, [-math.pi, math.pi],
                                          o['betag_range' + suffix], o['betap_range' + suffix],
                                          noise_range=None, rng=self._rng)
        pad_size = (KERNEL_SIZE - kernel_size) // 2
        return np.pad(kernel, ((pad_size, pad_size), (pad_size, pad_size))).astype(np.float32)

    def _read(self, index):
        """(HWC float32 BGR image, path); a failed read is retried up to
        three times, each on a random other index."""
        gt_path = self.paths[index]
        for retry in range(2, -1, -1):
            try:
                return imfrombytes(self.file_client.get(gt_path, 'gt'), float32=True), gt_path
            except (IOError, OSError) as e:
                get_root_logger().warning(f'File client error: {e}, remaining retry times: '
                                          f'{retry}')
                if retry == 0:
                    raise
                with self._rng_lock:
                    gt_path = self.paths[self._rng.randint(0, len(self.paths))]
                time.sleep(1)

    def __getitem__(self, index):
        img_gt, gt_path = self._read(index)
        crop_pad_size = self.opt.get('crop_pad_size', 400)
        with self._rng_lock:
            img_gt = augment(img_gt, self.opt.get('use_hflip', True),
                             self.opt.get('use_rot', True),
                             rng=np.random.default_rng(self._rng.randint(0, 2**31)))
            h, w = img_gt.shape[0:2]
            if h < crop_pad_size or w < crop_pad_size:
                img_gt = cv2.copyMakeBorder(img_gt, 0, max(0, crop_pad_size - h), 0,
                                            max(0, crop_pad_size - w), cv2.BORDER_REFLECT_101)
            if img_gt.shape[0] > crop_pad_size or img_gt.shape[1] > crop_pad_size:
                h, w = img_gt.shape[0:2]
                top = self._rng.randint(0, h - crop_pad_size + 1)
                left = self._rng.randint(0, w - crop_pad_size + 1)
                img_gt = img_gt[top:top + crop_pad_size, left:left + crop_pad_size, ...]

            kernel = self._sample_kernel('')
            kernel2 = self._sample_kernel('2')
            if self._rng.uniform() < self.opt['final_sinc_prob']:
                kernel_size = int(self._rng.choice(self.kernel_range))
                omega_c = self._rng.uniform(np.pi / 3, np.pi)
                sinc_kernel = circular_lowpass_kernel(omega_c, kernel_size,
                                                      pad_to=KERNEL_SIZE).astype(np.float32)
            else:
                sinc_kernel = self.pulse_tensor

        return {'gt': img2tensor(img_gt, bgr2rgb=True, float32=True),
                'kernel1': torch.from_numpy(kernel), 'kernel2': torch.from_numpy(kernel2),
                'sinc_kernel': torch.from_numpy(np.ascontiguousarray(sinc_kernel)),
                'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class RealESRGANPairedDataset:
    """LQ/GT pairs for fine-tuning: ``meta_info`` lines ``gt_path, lq_path``
    or the two folders; the train phase takes an aligned random crop
    (``gt_size``) and flips, drawn from ``np.random.default_rng(manual_seed)``;
    ``mean`` / ``std`` normalise both."""

    def __init__(self, opt):
        self.opt = opt
        io_backend_opt = dict(opt.get('io_backend', {'type': 'disk'}))
        self.file_client = FileClient(io_backend_opt.pop('type'), **io_backend_opt)
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.gt_folder, self.lq_folder = opt['dataroot_gt'], opt['dataroot_lq']

        if opt.get('meta_info') is not None:
            with open(opt['meta_info']) as fin:
                lines = [line.strip() for line in fin]
            self.paths = []
            for line in lines:
                gt_path, lq_path = line.split(', ')
                self.paths.append({'gt_path': os.path.join(self.gt_folder, gt_path),
                                   'lq_path': os.path.join(self.lq_folder, lq_path)})
        else:
            self.paths = paired_paths_from_folder([self.lq_folder, self.gt_folder], ['lq', 'gt'],
                                                  opt.get('filename_tmpl', '{}'))
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def __getitem__(self, index):
        scale = self.opt['scale']
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt = imfrombytes(self.file_client.get(gt_path, 'gt'), float32=True)
        img_lq = imfrombytes(self.file_client.get(lq_path, 'lq'), float32=True)

        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.opt['gt_size'], scale, gt_path,
                                                rng=self._rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get('use_hflip', True),
                                     self.opt.get('use_rot', True), rng=self._rng)

        img_gt, img_lq = img2tensor([img_gt, img_lq], bgr2rgb=True, float32=True)
        if self.mean is not None or self.std is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32).view(-1, 1, 1)
            std = torch.tensor(self.std, dtype=torch.float32).view(-1, 1, 1)
            img_lq = (img_lq - mean) / std
            img_gt = (img_gt - mean) / std
        return {'lq': img_lq, 'gt': img_gt, 'lq_path': lq_path, 'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
