"""NIQE, the Natural Image Quality Evaluator, a no-reference metric
(counterpart of ``basicsr4rs_tpu/metrics/niqe.py``; reference:
basicsr/metrics/niqe.py; Mittal et al., IEEE SPL 2013). A host metric in
numpy and scipy, as in the JAX package.

Y channel (MATLAB coefficients) or gray, rounded; per 96x96 block the MSCN
coefficients (7x7 Gaussian local mean and std), moment-matched AGGD fits of
the field and of its four neighbour products: 18 features; again at half
scale (MATLAB bicubic): 36; then the Mahalanobis distance between the
blocks' Gaussian and the pristine one. ``niqe_pris_params.npz`` beside this
file holds the pristine mean, covariance and the 7x7 window, public data of
the official NIQE release. MATLAB's value on ``tests/data/baboon.png`` is
5.7296.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from ..utils.matlab_functions import imresize
from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import reorder_image, to_y_channel

PARAMS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'niqe_pris_params.npz')
# the AGGD shape's inversion: candidate alphas and their ratio r(alpha)
_ALPHA_GRID = np.arange(0.2, 10.001, 0.001)
_inv = 1.0 / _ALPHA_GRID
_R_ALPHA = gamma(2 * _inv)**2 / (gamma(_inv) * gamma(3 * _inv))


def estimate_aggd_param(block: np.ndarray) -> Tuple[float, float, float]:
    """(alpha, beta_left, beta_right) of a moment-matched AGGD fit."""
    vec = block.ravel()
    left_std = np.sqrt(np.mean(vec[vec < 0]**2))
    right_std = np.sqrt(np.mean(vec[vec > 0]**2))
    gamma_hat = left_std / right_std
    r_hat = np.mean(np.abs(vec))**2 / np.mean(vec**2)
    r_hat_norm = r_hat * (gamma_hat**3 + 1) * (gamma_hat + 1) / (gamma_hat**2 + 1)**2
    alpha = _ALPHA_GRID[np.argmin((_R_ALPHA - r_hat_norm)**2)]
    scale = np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, left_std * scale, right_std * scale


def _block_features(block: np.ndarray) -> list:
    """The 18 features of one MSCN block."""
    alpha, bl, br = estimate_aggd_param(block)
    feat = [alpha, (bl + br) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        alpha, bl, br = estimate_aggd_param(block * np.roll(block, shift, axis=(0, 1)))
        mean = (br - bl) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def niqe_core(img: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
              gaussian_window: np.ndarray, block_h: int = 96, block_w: int = 96) -> float:
    """NIQE of a 2-D [0, 255] float image against the pristine Gaussian."""
    if img.ndim != 2:
        raise ValueError('NIQE input must be a 2D gray/Y image.')
    h, w = img.shape
    nb_h, nb_w = math.floor(h / block_h), math.floor(w / block_w)
    img = img[:nb_h * block_h, :nb_w * block_w]

    features = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode='nearest')
        sigma = np.sqrt(np.abs(convolve(img**2, gaussian_window, mode='nearest') - mu**2))
        mscn = (img - mu) / (sigma + 1)
        features.append(np.array([
            _block_features(mscn[ih * block_h // scale:(ih + 1) * block_h // scale,
                                 iw * block_w // scale:(iw + 1) * block_w // scale])
            for iw in range(nb_w) for ih in range(nb_h)]))
        if scale == 1:
            img = imresize(img / 255., 0.5, antialiasing=True) * 255.

    features = np.concatenate(features, axis=1)
    mu_dist = np.nanmean(features, axis=0)
    cov_dist = np.cov(features[~np.isnan(features).any(axis=1)], rowvar=False)
    inv_cov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    diff = np.ravel(mu_pris) - mu_dist
    return float(np.sqrt(diff @ inv_cov @ diff))


def load_niqe_params(params_path: Optional[str] = None):
    """(mu, cov, window) of the pristine model; ``params_path`` replaces the
    file beside this module."""
    params = np.load(params_path or PARAMS_PATH)
    return params['mu_pris_param'], params['cov_pris_param'], params['gaussian_window']


def _preprocess(img: np.ndarray, crop_border: int = 0, input_order: str = 'HWC',
                convert_to: Optional[str] = 'y', input_bands: Optional[Sequence[int]] = None,
                band: Optional[int] = None) -> np.ndarray:
    """Band selection, colour conversion, border crop, MATLAB's rounding."""
    img = img.astype(np.float32)
    if input_order != 'HW':
        img = reorder_image(img, input_order=input_order)
        if input_bands is not None:
            img = img[..., list(input_bands)]
        if band is not None:
            img = img[..., band]
        if convert_to == 'y':
            img = to_y_channel(img)
        elif convert_to == 'gray':
            img = cv2.cvtColor(img / 255., cv2.COLOR_BGR2GRAY) * 255.
        img = np.squeeze(img)
    if crop_border > 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return img.round()


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border: int, input_order: str = 'HWC', convert_to: str = 'y',
                   **kwargs) -> float:
    """NIQE of a [0, 255] BGR or gray image."""
    mu, cov, window = load_niqe_params(kwargs.get('params_path'))
    return niqe_core(_preprocess(img, crop_border, input_order, convert_to), mu, cov, window)


@METRIC_REGISTRY.register()
def calculate_rs_niqe(img, crop_border: int, input_order: str = 'HWC', convert_to: str = 'y',
                      input_bands: Sequence[int] = (2, 1, 0), **kwargs) -> float:
    """NIQE of three bands of a multispectral image, taken as BGR."""
    mu, cov, window = load_niqe_params(kwargs.get('params_path'))
    return niqe_core(_preprocess(img, crop_border, input_order, convert_to,
                                 input_bands=input_bands), mu, cov, window)


@METRIC_REGISTRY.register()
def calculate_niqe_band(img, crop_border: int, band: int, input_order: str = 'HWC',
                        **kwargs) -> float:
    """NIQE of one spectral band."""
    mu, cov, window = load_niqe_params(kwargs.get('params_path'))
    return niqe_core(_preprocess(img, crop_border, input_order, convert_to=None, band=band),
                     mu, cov, window)


@METRIC_REGISTRY.register()
def calculate_niqe_none(**kwargs) -> float:
    """A placeholder metric: -1."""
    return -1
