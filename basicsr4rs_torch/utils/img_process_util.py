"""Batched image filtering and USM sharpening (counterpart of
``basicsr4rs_tpu/utils/img_process_util.py``; reference:
basicsr/utils/img_process_util.py). NCHW tensors in [0, 1].

``filter2D`` runs a per-sample kernel over every channel as one grouped
convolution over N*C groups; ``sep_filter2d`` and the USM run a 1D kernel
along H, then along W (k + k taps a pixel instead of k * k: USM's 101-tap
Gaussian would be 58 GFLOP a batch of 12 x 400 x 400 as a dense filter).
Both pad by reflection.
"""

from __future__ import annotations

import cv2
import torch
import torch.nn.functional as F
from torch import nn


def filter2D(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``img`` (N, C, H, W) filtered by ``kernel``: (k, k), shared, or (N, k,
    k), one a sample, each applied to every channel of its sample (a
    correlation, as ``F.conv2d``); k odd, reflect padding of k // 2."""
    n, c, h, w = img.shape
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError('Wrong kernel size')
    pad = k // 2
    x = F.pad(img, (pad, pad, pad, pad), mode='reflect').reshape(1, n * c, h + 2 * pad,
                                                                  w + 2 * pad)
    kernel = kernel.to(img.dtype).expand(n, k, k) if kernel.dim() == 2 else kernel.to(img.dtype)
    weight = kernel.repeat_interleave(c, dim=0).reshape(n * c, 1, k, k)
    return F.conv2d(x, weight, groups=n * c).reshape(n, c, h, w)


def sep_filter2d(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """``img`` (N, C, H, W) filtered by the outer product of the 1D kernel
    ``k1d`` (k,) with itself: along H, then along W; k odd, reflect padding
    of k // 2."""
    n, c, h, w = img.shape
    k = k1d.shape[0]
    if k % 2 != 1:
        raise ValueError('Wrong kernel size')
    pad = k // 2
    x = F.pad(img, (pad, pad, pad, pad), mode='reflect').reshape(1, n * c, h + 2 * pad,
                                                                  w + 2 * pad)
    k1d = k1d.to(img.dtype)
    x = F.conv2d(x, k1d.view(1, 1, k, 1).expand(n * c, 1, k, 1), groups=n * c)
    x = F.conv2d(x, k1d.view(1, 1, 1, k).expand(n * c, 1, 1, k), groups=n * c)
    return x.reshape(n, c, h, w)


def gaussian_kernel1d(radius: int, sigma: float = 0) -> torch.Tensor:
    """cv2's Gaussian of ``radius`` taps (made odd) as float32."""
    if radius % 2 == 0:
        radius += 1
    return torch.from_numpy(cv2.getGaussianKernel(radius, sigma)[:, 0]).float()


def _usm(img, k1d, weight, threshold):
    blur = sep_filter2d(img, k1d)
    residual = img - blur
    mask = (torch.abs(residual) * 255 > threshold).to(img.dtype)
    soft_mask = sep_filter2d(mask, k1d)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: int = 10) -> torch.Tensor:
    """Unsharp masking with a soft threshold mask."""
    return _usm(img, gaussian_kernel1d(radius).to(img.device), weight, threshold)


class USMSharp(nn.Module):
    """``usm_sharp`` with the Gaussian kept as a buffer (it follows
    ``.to(device)``)."""

    def __init__(self, radius: int = 50, sigma: float = 0):
        super().__init__()
        self.register_buffer('k1d', gaussian_kernel1d(radius, sigma), persistent=False)

    def forward(self, img, weight: float = 0.5, threshold: int = 10):
        return _usm(img, self.k1d, weight, threshold)
