"""Color-space conversions with MATLAB (ITU-R BT.601) coefficients
(counterpart of ``basicsr4rs_tpu/utils/color_util.py``; reference:
basicsr/utils/color_util.py). They feed the Y-channel PSNR/SSIM protocol,
so coefficients and rounding match MATLAB's ``rgb2ycbcr``. numpy, float64;
``rgb2ycbcr_pt`` on tensors, for the device metrics."""

from __future__ import annotations

import numpy as np
import torch

# MATLAB rgb2ycbcr matrix, indexed [rgb_channel, ycbcr_channel]: input in
# [0, 1], output in [0, 255] before the range is restored.
_YCBCR_WEIGHTS = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
], dtype=np.float64)
_YCBCR_BIAS = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def _convert_input_type_range(img: np.ndarray) -> np.ndarray:
    """To float64 in [0, 1]."""
    img_type = img.dtype
    img = img.astype(np.float64)
    if img_type == np.uint8:
        img /= 255.
    elif img_type not in (np.float32, np.float64):
        raise TypeError(f'The img type should be np.float32/64 or np.uint8, but got {img_type}')
    return img


def _convert_output_type_range(img: np.ndarray, dst_type) -> np.ndarray:
    """Back to the caller's dtype convention."""
    if dst_type not in (np.uint8, np.float32, np.float64):
        raise TypeError(f'The dst_type should be np.float32/64 or np.uint8, but got {dst_type}')
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.
    return img.astype(dst_type)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """RGB -> YCbCr (or Y only), MATLAB convention."""
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = img @ _YCBCR_WEIGHTS[:, 0] + 16.0
    else:
        out = img @ _YCBCR_WEIGHTS + _YCBCR_BIAS
    return _convert_output_type_range(out, img_type.type)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR -> YCbCr (or Y only)."""
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """YCbCr -> RGB, the inverse of ``rgb2ycbcr``."""
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255.
    out = (img - _YCBCR_BIAS) @ np.linalg.inv(_YCBCR_WEIGHTS) * 255.
    return _convert_output_type_range(out, img_type.type)


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    return ycbcr2rgb(img)[..., ::-1]


def rgb2ycbcr_pt(img: torch.Tensor, y_only: bool = False) -> torch.Tensor:
    """RGB -> YCbCr (or Y only) of NCHW tensors in [0, 1], in [0, 1], in the
    tensor's dtype and on its device."""
    weights = torch.as_tensor(_YCBCR_WEIGHTS, dtype=img.dtype, device=img.device)
    if y_only:
        out = torch.einsum('nchw,c->nhw', img, weights[:, 0])[:, None] + 16.0
    else:
        bias = torch.as_tensor(_YCBCR_BIAS, dtype=img.dtype, device=img.device)
        out = torch.einsum('nchw,cd->ndhw', img, weights) + bias[:, None, None]
    return out / 255.
