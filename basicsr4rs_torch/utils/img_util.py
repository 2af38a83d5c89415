"""Image <-> tensor conversion and image I/O (counterpart of
``basicsr4rs_tpu/utils/img_util.py``; reference: basicsr/utils/img_util.py).

The port keeps BasicSR's torch convention: images on the host are numpy HWC
BGR (cv2's order), tensors are CHW / NCHW RGB floats in [0, 1].
"""

from __future__ import annotations

import os
from typing import Tuple

import cv2
import numpy as np
import torch


def img2tensor(imgs, bgr2rgb: bool = True, float32: bool = True):
    """HWC numpy image(s) (BGR, cv2 order) -> CHW torch tensor(s), RGB."""

    def _totensor(img):
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 3 and bgr2rgb:
            img = img[:, :, ::-1]
        tensor = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
        return tensor.float() if float32 else tensor

    if isinstance(imgs, list):
        return [_totensor(img) for img in imgs]
    return _totensor(imgs)


def tensor2img(tensor, rgb2bgr: bool = True, out_type=np.uint8,
               min_max: Tuple[float, float] = (0, 1)):
    """Tensor(s) of shape (1, C, H, W), (C, H, W) or (H, W) -> HWC numpy
    image(s): clamped to ``min_max``, rescaled to [0, 1], RGB -> BGR, and for
    uint8 scaled by 255 and rounded."""
    single = torch.is_tensor(tensor)
    result = []
    for t in ([tensor] if single else tensor):
        t = t.detach().float().cpu()
        if t.dim() == 4:
            if t.shape[0] != 1:
                raise ValueError(f'tensor2img takes one image, got a batch of {t.shape[0]}')
            t = t[0]
        t = (t.clamp(*min_max) - min_max[0]) / (min_max[1] - min_max[0])
        img = t.numpy()
        if img.ndim == 3:
            img = img.transpose(1, 2, 0)
            if img.shape[2] == 1:
                img = img[:, :, 0]
            elif img.shape[2] == 3 and rgb2bgr:
                img = img[:, :, ::-1]
        if out_type == np.uint8:
            img = (img * 255.0).round()
        result.append(np.ascontiguousarray(img.astype(out_type)))
    return result[0] if single else result


def minusone_one_tensor_to_ubyte_numpy(tensor, rgb2bgr: bool = True):
    """The remote-sensing convention: tensor(s) in [-1, 1] -> uint8 HWC image(s)."""
    return tensor2img(tensor, rgb2bgr=rgb2bgr, out_type=np.uint8, min_max=(-1, 1))


def imfrombytes(content: bytes, flag: str = 'color', float32: bool = False) -> np.ndarray:
    """Decode image bytes with cv2 (BGR for color)."""
    flags = {'color': cv2.IMREAD_COLOR, 'grayscale': cv2.IMREAD_GRAYSCALE,
             'unchanged': cv2.IMREAD_UNCHANGED}
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags[flag])
    if img is None:
        raise ValueError('cv2 could not decode the image bytes')
    if float32:
        img = img.astype(np.float32) / 255.
    return img


def imwrite(img: np.ndarray, file_path: str, params=None, auto_mkdir: bool = True) -> None:
    """cv2.imwrite that creates the parent directory."""
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    if not cv2.imwrite(file_path, img, params or []):
        raise IOError(f'Failed in writing {file_path}.')
