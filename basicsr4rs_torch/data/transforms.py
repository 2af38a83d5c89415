"""Host-side image transforms on numpy HWC arrays (counterpart of
``basicsr4rs_tpu/data/transforms.py``; reference: basicsr/data/transforms.py).
Randomness comes from an explicit ``numpy.random.Generator``, drawn in the
JAX package's order, so the same seed gives the same crops and flips in
both packages. The flow-aware augmentation and the remote-sensing
normalizers come with the models that use them."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

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
