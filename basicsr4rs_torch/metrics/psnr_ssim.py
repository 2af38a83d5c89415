"""PSNR / SSIM with the reference's numeric conventions (counterpart of
``basicsr4rs_tpu/metrics/psnr_ssim.py``; reference:
basicsr/metrics/psnr_ssim.py).

Images in the [0, 255] range (uint8 or float), ``crop_border`` pixels
removed per edge, optional Y-channel evaluation with MATLAB coefficients,
float64 math. SSIM: 11x11 Gaussian window (sigma 1.5), C1=(0.01*255)^2,
C2=(0.03*255)^2, valid region, averaged over channels.

``calculate_psnr_pt`` and ``calculate_ssim_pt`` (also registered as
``calculate_psnr_jax`` and ``calculate_ssim_jax``, the JAX package's names)
compute the same on the device, in float32, on NCHW batches in [0, 1]:
SSIM with C1=0.01^2 and C2=0.03^2, as the JAX package's device variants.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..utils.color_util import bgr2ycbcr, rgb2ycbcr_pt
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


# ---------------------------------------------------------------------------
# Device variants: float32 NCHW batches in [0, 1], one value a sample.
# ---------------------------------------------------------------------------

def _to_nchw01(img, device=None) -> torch.Tensor:
    """A metric input as a float32 NCHW **RGB** tensor in [0, 1]: a float
    tensor (N)CHW as it is (a validation output: RGB); a uint8 array or
    tensor scaled by 1/255, and when it has 3 channels flipped from BGR
    (``tensor2img``'s order) to RGB; numpy images are HW(C). ``device``: the
    device a numpy image goes to (default: the CPU)."""
    if isinstance(img, np.ndarray):
        arr = img[..., None] if img.ndim == 2 else img
        arr = np.ascontiguousarray(arr.transpose(2, 0, 1) if arr.ndim == 3
                                   else arr.transpose(0, 3, 1, 2))
        img = torch.from_numpy(arr).to(device)
    is_uint8 = img.dtype == torch.uint8
    img = img.float() * (1. / 255. if is_uint8 else 1.)
    if img.dim() == 3:
        img = img[None]
    if is_uint8 and img.shape[1] == 3:
        img = img.flip(1)
    return img


def _prepare_pt(img, img2, crop_border, test_y_channel):
    img = _to_nchw01(img)
    img2 = _to_nchw01(img2, img.device).to(img.device)
    if img.shape != img2.shape:
        raise ValueError(f'Image shapes are different: {img.shape}, {img2.shape}.')
    if crop_border != 0:
        img = img[..., crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[..., crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img, img2 = rgb2ycbcr_pt(img, y_only=True), rgb2ycbcr_pt(img2, y_only=True)
    return img, img2


def psnr_per_sample(img, img2, crop_border: int, test_y_channel: bool = False):
    """PSNR in dB of each sample, ``10 log10(1 / mse)`` on [0, 1]."""
    img, img2 = _prepare_pt(img, img2, crop_border, test_y_channel)
    return -10. * torch.log10(((img - img2)**2).mean(dim=(1, 2, 3)))


def ssim_per_sample(img, img2, crop_border: int, test_y_channel: bool = False):
    """SSIM of each sample: an 11x11 Gaussian (sigma 1.5) depthwise valid
    convolution, C1=0.01^2 and C2=0.03^2, the map's mean over channels and
    pixels."""
    img, img2 = _prepare_pt(img, img2, crop_border, test_y_channel)
    c = img.shape[1]
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = torch.as_tensor(np.outer(kernel, kernel.transpose()), dtype=torch.float32,
                             device=img.device).expand(c, 1, 11, 11)

    def conv(x):
        return F.conv2d(x, window, groups=c)

    c1, c2 = 0.01**2, 0.03**2
    mu1, mu2 = conv(img), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = conv(img**2) - mu1_sq
    sigma2_sq = conv(img2**2) - mu2_sq
    sigma12 = conv(img * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))


@METRIC_REGISTRY.register()
def calculate_psnr_pt(img, img2, crop_border: int, test_y_channel: bool = False,
                      **kwargs) -> float:
    """PSNR of two batches on their device: the batch's mean in dB."""
    return float(psnr_per_sample(img, img2, crop_border, test_y_channel).mean())


@METRIC_REGISTRY.register()
def calculate_ssim_pt(img, img2, crop_border: int, test_y_channel: bool = False,
                      **kwargs) -> float:
    """SSIM of two batches on their device: the batch's mean."""
    return float(ssim_per_sample(img, img2, crop_border, test_y_channel).mean())


METRIC_REGISTRY.register(calculate_psnr_pt, name='calculate_psnr_jax')
METRIC_REGISTRY.register(calculate_ssim_pt, name='calculate_ssim_jax')
