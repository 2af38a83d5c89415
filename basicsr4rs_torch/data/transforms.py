"""Host-side image transforms on numpy HWC arrays (counterpart of
``basicsr4rs_tpu/data/transforms.py``; reference: basicsr/data/transforms.py).
Randomness comes from an explicit ``numpy.random.Generator``, drawn in the
JAX package's order, so the same seed gives the same crops and flips in
both packages. The remote-sensing normalizers act on the CHW tensors that
``img2tensor`` makes (the JAX package's on HWC arrays), with the same
float32 arithmetic. The flow-aware augmentation comes with the model that
uses it."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import cv2
import numpy as np
import torch

ImgOrList = Union[np.ndarray, List[np.ndarray]]


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H and W to multiples of ``scale``."""
    if img.ndim not in (2, 3):
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


def paired_random_crop(img_gts: ImgOrList, img_lqs: ImgOrList, gt_patch_size: int, scale: int,
                       gt_path: str = '',
                       rng: Optional[np.random.Generator] = None) -> Tuple[ImgOrList, ImgOrList]:
    """Random aligned crop of GT/LQ pairs: a ``gt_patch_size`` GT patch and
    the LQ patch under it."""
    rng = rng or np.random.default_rng()
    gt_is_list, lq_is_list = isinstance(img_gts, list), isinstance(img_lqs, list)
    gts = img_gts if gt_is_list else [img_gts]
    lqs = img_lqs if lq_is_list else [img_lqs]

    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x '
                         f'multiplication of LQ ({h_lq}, {w_lq}). Path: {gt_path}')
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f'LQ ({h_lq}, {w_lq}) is smaller than patch size '
                         f'({lq_patch_size}, {lq_patch_size}). Path: {gt_path}')

    top = int(rng.integers(0, h_lq - lq_patch_size + 1))
    left = int(rng.integers(0, w_lq - lq_patch_size + 1))
    lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...] for v in lqs]
    top_gt, left_gt = top * scale, left * scale
    gts = [v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size, ...] for v in gts]
    return (gts if gt_is_list else gts[0]), (lqs if lq_is_list else lqs[0])


def paired_central_crop(img_gts: ImgOrList, img_lqs: ImgOrList, gt_patch_size: int, scale: int,
                        gt_path: str = '') -> Tuple[ImgOrList, ImgOrList]:
    """The centred ``gt_patch_size`` GT patch and the LQ patch under it."""
    gt_is_list, lq_is_list = isinstance(img_gts, list), isinstance(img_lqs, list)
    gts = img_gts if gt_is_list else [img_gts]
    lqs = img_lqs if lq_is_list else [img_lqs]
    h_lq, w_lq = lqs[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    top, left = (h_lq - lq_patch_size) // 2, (w_lq - lq_patch_size) // 2
    lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...] for v in lqs]
    top_gt, left_gt = top * scale, left * scale
    gts = [v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size, ...] for v in gts]
    return (gts if gt_is_list else gts[0]), (lqs if lq_is_list else lqs[0])


def augment(imgs: ImgOrList, hflip: bool = True, rotation: bool = True,
            return_status: bool = False, rng: Optional[np.random.Generator] = None):
    """Random horizontal flip, vertical flip and 90-degree rotation, the same
    for every image of the list."""
    rng = rng or np.random.default_rng()
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.transpose(1, 0)
        return np.ascontiguousarray(img)

    single = not isinstance(imgs, list)
    out = [_augment(v) for v in ([imgs] if single else imgs)]
    out = out[0] if single else out
    return (out, (hflip, vflip, rot90)) if return_status else out


def chw2hwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(1, 2, 0))


def hwc2chw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def resize_hwc(array: np.ndarray, scale_factor: float) -> np.ndarray:
    """Nearest-neighbour resize of an HWC array to ``int(size * scale_factor)``."""
    h, w, c = array.shape
    out_h, out_w = int(h * scale_factor), int(w * scale_factor)
    return cv2.resize(array, (out_w, out_h), interpolation=cv2.INTER_NEAREST).reshape(out_h, out_w, c)


# ------------------------------------------- remote-sensing normalizers (CHW)
class SatNorm:
    """Digital numbers -> surface reflectance -> / ``max_sr`` -> [-1, 1]."""

    def __init__(self, scale_to_sr: float, offset_to_sr: float, max_sr: float, band_num: int):
        self.scale_to_sr = scale_to_sr
        self.offset_to_sr = offset_to_sr
        self.max_sr = max_sr
        self.band_num = band_num

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        x = img.float() * self.scale_to_sr + self.offset_to_sr
        x = x / self.max_sr
        return x * 2.0 - 1.0


class LandsatNorm(SatNorm):
    """Landsat Collection-2 level-2 reflectance scaling."""

    def __init__(self, band_num: int, max_sr: float):
        super().__init__(scale_to_sr=0.0000275, offset_to_sr=-0.2, max_sr=max_sr,
                         band_num=band_num)


class SentinelNorm(SatNorm):
    """Sentinel-2 level-2A reflectance scaling."""

    def __init__(self, band_num: int, max_sr: float):
        super().__init__(scale_to_sr=0.0001, offset_to_sr=0.0, max_sr=max_sr, band_num=band_num)


class Mean2StdNormalize:
    """Map mean +- one std of each band to [-1, 1], clamped."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = torch.tensor(np.asarray(mean, dtype=np.float32)).view(-1, 1, 1)
        self.std = torch.tensor(np.asarray(std, dtype=np.float32)).view(-1, 1, 1)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if img.shape[0] != self.mean.shape[0]:
            raise ValueError(f'Expected {self.mean.shape[0]} channels, but got {img.shape[0]}')
        min_value = self.mean - self.std
        max_value = self.mean + self.std
        normalized = 2 * (img - min_value) / (max_value - min_value) - 1
        return normalized.clamp(-1.0, 1.0)


def build_normalizer(source_dict: dict, bands: Sequence[str]) -> Mean2StdNormalize:
    """A ``Mean2StdNormalize`` from a {band: {'mean', 'std'}} table."""
    return Mean2StdNormalize(mean=[source_dict[band]['mean'] for band in bands],
                             std=[source_dict[band]['std'] for band in bands])
