"""Landsat -> Sentinel paired tile datasets (counterpart of
``basicsr4rs_tpu/data/l2s_single_dataset.py``; reference:
basicsr/data/l2s_single_dataset.py).

The tree is ``<root>/<tile>/<window>/<time>/<source>/<band>.tif``, sources
``landsat`` (LQ), ``sentinel`` and ``sentinel_hm`` (GT), with a
``metric.json`` / ``metric_hm.json`` per tile that scores each window and
time. Per-band GeoTIFFs are read with rasterio when it is installed, else
with cv2's TIFF reader (single-band uncompressed tiles). An item is
``{'lq': {'rgb', 'nss'}, 'gt': {'rgb', 'nss'}, 'sample_path', 'img_name'}``
with CHW float32 tensors in [-1, 1]; the NSS group (NIR, SWIR1, SWIR2) of the
Sentinel GT lies on half the RGB grid. Crops and flips draw from the
dataset's own generator seeded with ``manual_seed``, in the JAX package's
order.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..utils.img_util import img2tensor
from ..utils.registry import DATASET_REGISTRY
from .transforms import (LandsatNorm, SentinelNorm, augment, chw2hwc, paired_central_crop,
                         paired_random_crop, resize_hwc)

BAND_NUM = 3
RGB_SCALE = 0.3
NSS_SCALE = 0.5


def merge_last_three_folder_names(folder_path: str, sep: str = '_') -> str:
    """``tile_window_time`` of a sample's folder."""
    parts = Path(folder_path).resolve().parts
    if len(parts) < 3:
        raise ValueError('path has fewer than three levels')
    return sep.join(parts[-3:])


def _read_band(band_path: str) -> np.ndarray:
    try:
        import rasterio
        with rasterio.open(band_path) as src:
            return src.read(1).astype(np.float32)
    except ImportError:
        import cv2
        arr = cv2.imread(band_path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f'cannot read band {band_path} (rasterio unavailable, cv2 failed)')
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.float32)


def load_grouped_numpy(window_path: str, source: str, band_list: Sequence[str]) -> np.ndarray:
    """The bands of one source, stacked: (C, H, W) float32."""
    source_path = os.path.join(window_path, source)
    return np.stack([_read_band(os.path.join(source_path, band)) for band in band_list])


def filter_metrics(root_path: str, psnr_min: float, ssim_min: float, psnr_max: float,
                   use_hm: bool = True) -> dict:
    """{tile: {window: {time: {'psnr', 'ssim'}}}} of the samples whose
    scores lie in [psnr_min, psnr_max] and at or above ssim_min."""
    metric_filename = 'metric_hm.json' if use_hm else 'metric.json'
    filtered = {}
    for tile_id in sorted(os.listdir(root_path)):
        metrics_path = os.path.join(root_path, tile_id, metric_filename)
        if not os.path.isfile(metrics_path):
            continue
        try:
            with open(metrics_path, 'r', encoding='utf-8') as f:
                metrics = json.load(f)
        except (OSError, ValueError):   # an unreadable score file drops its tile
            continue
        one_tile = {}
        for window_id, time_dict in metrics.items():
            for time_str, values in time_dict.items():
                psnr = values.get('psnr', 0)
                ssim = values.get('ssim', 0)
                if psnr_max >= psnr >= psnr_min and ssim >= ssim_min:
                    one_tile.setdefault(window_id, {})[time_str] = {'psnr': psnr, 'ssim': ssim}
        if one_tile:
            filtered[tile_id] = one_tile
    return filtered


def get_sample_current_paths(metric_dict: dict) -> List[str]:
    """``tile/window/time`` of every sample, in the table's order."""
    return [os.path.join(tile_id, window_id, t)
            for tile_id, tile_dict in metric_dict.items()
            for window_id, time_dict in tile_dict.items() for t in time_dict]


def split_indices(n: int, split_percent: Sequence, split: int) -> np.ndarray:
    """The indices of part ``split`` of a seed-0 random split of ``n``
    items, with ``torch.utils.data.random_split``'s lengths: fractions that
    sum to 1 (the remainder spread one by one from the first part) or
    counts."""
    if all(isinstance(p, float) for p in split_percent):
        lengths = [int(np.floor(n * p)) for p in split_percent]
        for i in range(n - sum(lengths)):
            lengths[i % len(lengths)] += 1
    else:
        lengths = list(split_percent)
    perm = np.random.RandomState(0).permutation(n)
    starts = np.cumsum([0] + lengths)
    return perm[starts[split]:starts[split + 1]]


@DATASET_REGISTRY.register()
class L2SSingleDataset:
    """Landsat LQ and Sentinel GT of each sample that passes the score
    filter (``psnr_min``, ``ssim_min``, ``psnr_max``)."""
    sources = ['landsat', 'sentinel']
    rgb_scale = 3
    nss_scale = 1.5
    rgb_bands = ['red.tif', 'green.tif', 'blue.tif']
    nss_bands = ['nir08.tif', 'swir16.tif', 'swir22.tif']
    gt_source = 'sentinel'
    use_hm_metrics = False

    def __init__(self, opt: dict):
        self.opt = opt
        self.root_path = opt['root_path']
        self.metric_dict = filter_metrics(self.root_path, psnr_min=opt['psnr_min'],
                                          ssim_min=opt['ssim_min'], psnr_max=opt['psnr_max'],
                                          use_hm=self.use_hm_metrics)
        self.sample_current_paths = get_sample_current_paths(self.metric_dict)

        self.landsat_rgb_norm = LandsatNorm(BAND_NUM, RGB_SCALE)
        self.landsat_nss_norm = LandsatNorm(BAND_NUM, NSS_SCALE)
        self.sentinel_rgb_norm = SentinelNorm(BAND_NUM, RGB_SCALE)
        self.sentinel_nss_norm = SentinelNorm(BAND_NUM, NSS_SCALE)
        self._rng = np.random.default_rng(opt.get('manual_seed'))

    def get_sample_path(self, idx: int) -> str:
        return os.path.join(self.root_path, str(self.sample_current_paths[idx]))

    def __len__(self):
        return len(self.sample_current_paths)

    def __getitem__(self, idx):
        sample_path = self.get_sample_path(idx)

        lq_rgb = chw2hwc(load_grouped_numpy(sample_path, 'landsat', self.rgb_bands))
        lq_nss = chw2hwc(load_grouped_numpy(sample_path, 'landsat', self.nss_bands))
        gt_rgb = chw2hwc(load_grouped_numpy(sample_path, self.gt_source, self.rgb_bands))
        gt_nss = chw2hwc(load_grouped_numpy(sample_path, self.gt_source, self.nss_bands))
        # the NSS GT on the RGB grid while the pair is cropped and flipped
        gt_nss_up = resize_hwc(gt_nss, self.rgb_scale / self.nss_scale)

        img_gts, img_lqs = [gt_rgb, gt_nss_up], [lq_rgb, lq_nss]
        if self.opt['phase'] == 'train':
            img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, self.opt['gt_size'],
                                                  self.rgb_scale, sample_path, rng=self._rng)
            all_image = augment(img_gts + img_lqs, self.opt.get('use_hflip', False),
                                self.opt.get('use_rot', False), rng=self._rng)
            img_gts, img_lqs = all_image[:2], all_image[2:]
        else:
            img_gts, img_lqs = paired_central_crop(img_gts, img_lqs, self.opt['gt_size'],
                                                   self.rgb_scale, sample_path)

        gt_rgb, gt_nss_up = img_gts
        gt_nss = resize_hwc(gt_nss_up, self.nss_scale / self.rgb_scale)
        lq_rgb, lq_nss = img_lqs
        gt_rgb, gt_nss, lq_rgb, lq_nss = img2tensor([gt_rgb, gt_nss, lq_rgb, lq_nss],
                                                    bgr2rgb=False)
        return {
            'lq': {'rgb': self.landsat_rgb_norm(lq_rgb), 'nss': self.landsat_nss_norm(lq_nss)},
            'gt': {'rgb': self.sentinel_rgb_norm(gt_rgb), 'nss': self.sentinel_nss_norm(gt_nss)},
            'sample_path': sample_path,
            'img_name': merge_last_three_folder_names(sample_path),
        }


@DATASET_REGISTRY.register()
class L2SSingleSplitDataset:
    """Part ``split`` of a seed-0 random split (``split_percent``) of the
    samples of ``base_class``."""
    base_class = L2SSingleDataset

    def __init__(self, opt):
        self.opt = opt
        self.dataset = self.base_class(opt)
        self.indices = split_indices(len(self.dataset), opt['split_percent'], opt['split'])

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]
