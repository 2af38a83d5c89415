"""PSNR / SSIM with the reference's numeric conventions (counterpart of
``basicsr4rs_tpu/metrics/psnr_ssim.py``; reference:
basicsr/metrics/psnr_ssim.py).

Images in the [0, 255] range (uint8 or float), ``crop_border`` pixels
removed per edge, optional Y-channel evaluation with MATLAB coefficients,
float64 math. SSIM: 11x11 Gaussian window (sigma 1.5), C1=(0.01*255)^2,
C2=(0.03*255)^2, valid region, averaged over channels.
"""

from __future__ import annotations

import cv2
import numpy as np

from ..utils.color_util import bgr2ycbcr
from ..utils.registry import METRIC_REGISTRY


def reorder_image(img: np.ndarray, input_order: str = 'HWC') -> np.ndarray:
    """HWC or CHW -> HWC."""
    if input_order not in ('HWC', 'CHW'):
        raise ValueError(f"Wrong input_order {input_order}. Supported: 'HWC' and 'CHW'")
    if img.ndim == 2:
        return img[..., None]
    if input_order == 'CHW':
        return img.transpose(1, 2, 0)
    return img


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0, 255] BGR -> [0, 255] Y (MATLAB coefficients)."""
    img = img.astype(np.float32) / 255.
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)[..., None]
    return img * 255.


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f'Image shapes are different: {img.shape}, {img2.shape}.')
    img = reorder_image(img, input_order=input_order)
    img2 = reorder_image(img2, input_order=input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img: np.ndarray, img2: np.ndarray, crop_border: int,
                   input_order: str = 'HWC', test_y_channel: bool = False,
                   **kwargs) -> float:
    """PSNR in dB of [0, 255]-range images."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2)**2)
    if mse == 0:
        return float('inf')
    return float(10. * np.log10(255. * 255. / mse))


def _ssim(img: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM over the valid window region."""
    c1 = (0.01 * 255)**2
    c2 = (0.03 * 255)**2
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())

    mu1 = cv2.filter2D(img, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(img2, -1, window)[5:-5, 5:-5]
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = cv2.filter2D(img**2, -1, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = cv2.filter2D(img2**2, -1, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = cv2.filter2D(img * img2, -1, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img: np.ndarray, img2: np.ndarray, crop_border: int,
                   input_order: str = 'HWC', test_y_channel: bool = False,
                   **kwargs) -> float:
    """SSIM of [0, 255]-range images, averaged over channels."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    return float(np.mean([_ssim(img[..., i], img2[..., i]) for i in range(img.shape[2])]))


@METRIC_REGISTRY.register()
def calculate_psnr_band(img, img2, crop_border, band: int = 0, input_order='HWC',
                        **kwargs) -> float:
    """PSNR of one spectral band of two multispectral images."""
    img = reorder_image(np.asarray(img), input_order=input_order)
    img2 = reorder_image(np.asarray(img2), input_order=input_order)
    return calculate_psnr(img[..., band:band + 1], img2[..., band:band + 1], crop_border)


@METRIC_REGISTRY.register()
def calculate_ssim_band(img, img2, crop_border, band: int = 0, input_order='HWC',
                        **kwargs) -> float:
    """SSIM of one spectral band of two multispectral images."""
    img = reorder_image(np.asarray(img), input_order=input_order)
    img2 = reorder_image(np.asarray(img2), input_order=input_order)
    return calculate_ssim(img[..., band:band + 1], img2[..., band:band + 1], crop_border)
