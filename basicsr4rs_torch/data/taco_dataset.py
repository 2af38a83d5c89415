"""SEN2NAIP-style ``.taco`` archive datasets (counterpart of
``basicsr4rs_tpu/data/taco_dataset.py``; reference:
basicsr/data/taco_dataset.py). ``tacoreader`` and ``rasterio`` are optional:
without them the dataset raises ``ImportError`` when it is built. An item is
``{'lq', 'gt'}`` CHW float32 tensors of the ``band_idx`` bands scaled by
1/3000 to [-1, 1], and the two paths."""

from __future__ import annotations

import numpy as np

from ..utils.img_util import img2tensor
from ..utils.registry import DATASET_REGISTRY
from .l2s_single_dataset import split_indices
from .transforms import augment, paired_central_crop, paired_random_crop


@DATASET_REGISTRY.register()
class TacoDataset:

    def __init__(self, opt: dict):
        try:
            import tacoreader
            import rasterio  # noqa: F401
        except ImportError as e:
            raise ImportError('TacoDataset requires the optional `tacoreader` and `rasterio` '
                              f'packages: {e}')
        self.opt = opt
        self.scale = opt['scale']
        self.band_idx = opt['band_idx']
        self.scale_max = 3000
        self.dataset = tacoreader.load(opt['taco_paths'])
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        import rasterio as rio
        sample = self.dataset.read(idx)
        lq_path, gt_path = sample.read(0), sample.read(1)
        with rio.open(lq_path) as src, rio.open(gt_path) as dst:
            img_lq = np.ascontiguousarray(src.read(self.band_idx).transpose(1, 2, 0))
            img_gt = np.ascontiguousarray(dst.read(self.band_idx).transpose(1, 2, 0))

        gt_size = self.opt['gt_size']
        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size, self.scale, gt_path,
                                                rng=self._rng)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get('use_hflip', False),
                                     self.opt.get('use_rot', False), rng=self._rng)
        else:
            img_gt, img_lq = paired_central_crop(img_gt, img_lq, gt_size, self.scale, gt_path)

        img_gt, img_lq = img2tensor([img_gt.astype(np.float32), img_lq.astype(np.float32)],
                                    bgr2rgb=False)
        img_lq = (img_lq / self.scale_max) * 2.0 - 1.0
        img_gt = (img_gt / self.scale_max) * 2.0 - 1.0
        return {'lq': img_lq, 'gt': img_gt, 'lq_path': lq_path, 'gt_path': gt_path,
                'band_idx': self.band_idx}


@DATASET_REGISTRY.register()
class TacoSplitDataset:
    """Part ``split`` of a seed-0 random split of a ``TacoDataset``."""

    def __init__(self, opt):
        self.opt = opt
        self.dataset = TacoDataset(opt)
        self.indices = split_indices(len(self.dataset), opt['split_percent'], opt['split'])

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]
