"""Degradation synthesis (counterpart of ``basicsr4rs_tpu/data/degradations.py``;
reference: basicsr/data/degradations.py): blur-kernel synthesis on the host
(numpy) and batched noise on the model's device (torch, NCHW).

The host functions draw from the ``np.random.RandomState`` they are given
(``np.random`` when none is) and give the JAX package's kernels bit for bit
for the same state. The device noise separates its draws from its
arithmetic: ``gaussian_fields`` / ``poisson_fields`` draw the random fields
from an explicit ``torch.Generator``, and ``gaussian_noise`` /
``poisson_noise`` are deterministic given them, so that a caller (the
Real-ESRGAN degrader, a test) can supply every draw.

The Poisson sampler is the JAX package's distribution, not
``torch.poisson``: below lambda = 12 the inverse CDF with a 32-term cutoff,
at or above it ``max(0, round(lambda + sqrt(lambda) z))``. Its ``vals``
term is 2^ceil(log2(distinct 8-bit levels)) per sample, counted over the
256 levels with one scatter.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from scipy import special

from ..utils.diffjpeg import add_jpg_compression

# --------------------------------------------------------------------------
# Host-side blur kernel synthesis (numpy)
# --------------------------------------------------------------------------


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    """2x2 covariance from the axis sigmas and a rotation."""
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size: int):
    """(xy, xx, yy): the kernel's coordinate grid, centred at 0."""
    ax = np.arange(-kernel_size // 2 + 1., kernel_size // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape(kernel_size * kernel_size, 1),
                    yy.reshape(kernel_size * kernel_size, 1))).reshape(kernel_size, kernel_size, 2)
    return xy, xx, yy


def pdf2(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Unnormalised bivariate Gaussian on the grid."""
    inverse_sigma = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum(np.dot(grid, inverse_sigma) * grid, 2))


def _sigma_matrix(sig_x, sig_y, theta, isotropic):
    if isotropic:
        return np.array([[sig_x**2, 0], [0, sig_x**2]])
    return sigma_matrix2(sig_x, sig_y, theta)


def bivariate_Gaussian(kernel_size: int, sig_x: float, sig_y: float, theta: float,
                       grid=None, isotropic: bool = True) -> np.ndarray:
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(_sigma_matrix(sig_x, sig_y, theta, isotropic), grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size: int, sig_x: float, sig_y: float, theta: float,
                                   beta: float, grid=None, isotropic: bool = True) -> np.ndarray:
    """exp(-0.5 (x^T S^-1 x)^beta), normalised."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta, isotropic))
    kernel = np.exp(-0.5 * np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size: int, sig_x: float, sig_y: float, theta: float,
                      beta: float, grid=None, isotropic: bool = True) -> np.ndarray:
    """1 / (1 + (x^T S^-1 x)^beta), normalised."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta, isotropic))
    kernel = np.reciprocal(np.power(np.sum(np.dot(grid, inverse_sigma) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _sample_sigmas(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng):
    sigma_x = rng.uniform(sigma_x_range[0], sigma_x_range[1])
    if isotropic:
        return sigma_x, sigma_x, 0.
    sigma_y = rng.uniform(sigma_y_range[0], sigma_y_range[1])
    rotation = rng.uniform(rotation_range[0], rotation_range[1])
    return sigma_x, sigma_y, rotation


def _sample_beta(beta_range, rng):
    """Below or above 1 with even odds (beta = 1 is the plain Gaussian)."""
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def _multiplicative_noise(kernel, noise_range, rng):
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1], size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
                              noise_range=None, isotropic=True,
                              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    sx, sy, rot = _sample_sigmas(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    kernel = bivariate_Gaussian(kernel_size, sx, sy, rot, isotropic=isotropic)
    return _multiplicative_noise(kernel, noise_range, rng)


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                          rotation_range, beta_range, noise_range=None,
                                          isotropic=True, rng=None) -> np.ndarray:
    rng = rng or np.random
    sx, sy, rot = _sample_sigmas(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    beta = _sample_beta(beta_range, rng)
    kernel = bivariate_generalized_Gaussian(kernel_size, sx, sy, rot, beta, isotropic=isotropic)
    return _multiplicative_noise(kernel, noise_range, rng)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
                             beta_range, noise_range=None, isotropic=True, rng=None) -> np.ndarray:
    rng = rng or np.random
    sx, sy, rot = _sample_sigmas(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    beta = _sample_beta(beta_range, rng)
    kernel = bivariate_plateau(kernel_size, sx, sy, rot, beta, isotropic=isotropic)
    return _multiplicative_noise(kernel, noise_range, rng)


def random_mixed_kernels(kernel_list: Sequence[str],
                         kernel_prob: Sequence[float],
                         kernel_size: int = 21,
                         sigma_x_range=(0.6, 5),
                         sigma_y_range=(0.6, 5),
                         rotation_range=(-np.pi, np.pi),
                         betag_range=(0.5, 8),
                         betap_range=(0.5, 8),
                         noise_range=None,
                         rng=None) -> np.ndarray:
    """One kernel of the six-type mixture (the plateau kernels take no
    multiplicative noise)."""
    rng = rng or np.random
    kernel_type = rng.choice(kernel_list, p=kernel_prob)
    isotropic = kernel_type in ('iso', 'generalized_iso', 'plateau_iso')
    if kernel_type in ('iso', 'aniso'):
        return random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                         rotation_range, noise_range, isotropic=isotropic, rng=rng)
    if kernel_type in ('generalized_iso', 'generalized_aniso'):
        return random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                                     rotation_range, betag_range, noise_range,
                                                     isotropic=isotropic, rng=rng)
    if kernel_type in ('plateau_iso', 'plateau_aniso'):
        return random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                                        rotation_range, betap_range, None, isotropic=isotropic,
                                        rng=rng)
    raise ValueError(f'Unknown kernel type {kernel_type}')


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2D sinc low-pass filter of cutoff ``cutoff`` (radians), zero-padded
    to ``pad_to`` when that is larger."""
    if kernel_size % 2 != 1:
        raise ValueError('Kernel size must be an odd number.')
    center = (kernel_size - 1) / 2
    with np.errstate(divide='ignore', invalid='ignore'):
        kernel = np.fromfunction(
            lambda x, y: cutoff * special.j1(cutoff * np.sqrt((x - center)**2 + (y - center)**2))
            / (2 * np.pi * np.sqrt((x - center)**2 + (y - center)**2)),
            [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff**2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad_size = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad_size, pad_size), (pad_size, pad_size)))
    return kernel


def random_add_jpg_compression(img: np.ndarray, quality_range=(90, 100), rng=None) -> np.ndarray:
    """Real JPEG (cv2) of an HWC [0, 1] image at a quality drawn from
    ``quality_range``."""
    rng = rng or np.random
    quality = rng.uniform(quality_range[0], quality_range[1])
    return add_jpg_compression(img, quality)


# --------------------------------------------------------------------------
# Device-side noise (torch): NCHW batches, per-sample sigma / scale / gray.
# --------------------------------------------------------------------------

POISSON_SWITCH = 12.0   # lambda at which the sampler leaves the inverse CDF
POISSON_KMAX = 32       # terms of the inverse CDF: P(X > 31 | lambda = 12) ~ 4e-6
GRAY_COEF = (0.2989, 0.587, 0.114)   # torchvision's luminance weights


def _clip_round(out, clip: bool, rounds: bool):
    if rounds:
        out = (out * 255.0).round()
        return (out.clamp(0, 255) if clip else out) / 255.
    return out.clamp(0, 1) if clip else out


def _per_sample(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(-1, 1, 1, 1)


def gaussian_fields(shape, generator=None, device=None, dtype=torch.float32):
    """(colour, gray) standard normal fields of an (N, C, H, W) batch: (N, C,
    H, W) and (N, 1, H, W)."""
    n, _, h, w = shape
    return (torch.randn(shape, generator=generator, device=device, dtype=dtype),
            torch.randn((n, 1, h, w), generator=generator, device=device, dtype=dtype))


def gaussian_noise(sigma, gray_noise, fields):
    """Gaussian noise of per-sample ``sigma`` (in 255 units) from the
    normal fields; a sample with ``gray_noise`` 1 takes the one-channel
    field on every channel."""
    z, z_gray = fields
    sigma = _per_sample(sigma, z)
    gray = _per_sample(gray_noise, z)
    noise = z * sigma / 255.
    noise_gray = z_gray * sigma / 255.
    return noise * (1 - gray) + noise_gray * gray


def generate_gaussian_noise(img, sigma, gray_noise, generator=None):
    return gaussian_noise(sigma, gray_noise,
                          gaussian_fields(img.shape, generator, img.device, img.dtype))


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0., clip=True, rounds=False,
                              generator=None):
    """``img`` plus Gaussian noise of a per-sample sigma drawn from
    ``sigma_range``, gray with probability ``gray_prob``."""
    n = img.shape[0]
    sigma = torch.empty(n, device=img.device).uniform_(*sigma_range, generator=generator)
    gray = (torch.rand(n, device=img.device, generator=generator) < gray_prob).float()
    return _clip_round(img + generate_gaussian_noise(img, sigma, gray, generator), clip, rounds)


def poisson_vals(img):
    """2^ceil(log2(distinct 8-bit levels of each sample)), as (N,): the
    levels of ``round(255 img)`` marked in 256 bins by one scatter."""
    n = img.shape[0]
    levels = torch.round(img * 255.0).long().clamp_(0, 255).reshape(n, -1)
    present = torch.zeros(n, 256, dtype=torch.bool, device=img.device)
    present.scatter_(1, levels, True)
    uniq = present.sum(1).to(torch.float32)
    return torch.exp2(torch.ceil(torch.log2(uniq)))


def poisson_fields(shape, generator=None, device=None):
    """(u, z): the uniform and the normal field ``poisson_sample`` reads."""
    return (torch.rand(shape, generator=generator, device=device),
            torch.randn(shape, generator=generator, device=device))


def poisson_sample(lam, u, z):
    """Poisson(lam) from a uniform ``u`` and a normal ``z`` of lam's shape:
    the inverse CDF, pmf_{k+1} = pmf_k lam / (k + 1) over k < 32, below
    lam = 12; ``max(0, round(lam + sqrt(lam) z))`` from 12 on."""
    lam = lam.to(torch.float32)
    small = torch.clamp(lam, max=POISSON_SWITCH)   # keeps exp(-lam) conditioned
    pmf = torch.exp(-small)
    cdf = pmf.clone()
    count = torch.zeros_like(lam)
    for k in range(1, POISSON_KMAX):
        count += u > cdf
        pmf *= small / k
        cdf += pmf
    count += u > cdf
    normal = torch.clamp(torch.round(lam + torch.sqrt(lam) * z), min=0.0)
    return torch.where(lam < POISSON_SWITCH, count, normal)


def poisson_noise(img, scale, gray_noise, fields, gray_fields):
    """Poisson noise of ``img`` (N, C, H, W) times per-sample ``scale``:
    each sample's levels rounded to 8 bits, ``Poisson(img vals) / vals -
    img``; a sample with ``gray_noise`` 1 takes the noise of its luminance
    on every channel. ``fields`` / ``gray_fields``: ``poisson_fields`` of
    the image's and of a one-channel shape."""
    n = img.shape[0]
    gray = _per_sample(gray_noise, img)
    scale = _per_sample(scale, img)

    img_r = torch.clamp((img * 255.0).round(), 0, 255) / 255.
    vals = poisson_vals(img_r).reshape(n, 1, 1, 1)
    noise = poisson_sample(img_r * vals, *fields).to(img.dtype) / vals - img_r

    coef = torch.tensor(GRAY_COEF, dtype=img.dtype, device=img.device).view(1, -1, 1, 1)
    img_gray = torch.clamp(((img * coef).sum(1, keepdim=True) * 255.0).round(), 0, 255) / 255.
    vals_g = poisson_vals(img_gray).reshape(n, 1, 1, 1)
    noise_gray = poisson_sample(img_gray * vals_g, *gray_fields).to(img.dtype) / vals_g - img_gray

    return (noise * (1 - gray) + noise_gray * gray) * scale


def generate_poisson_noise(img, scale, gray_noise, generator=None):
    n, _, h, w = img.shape
    return poisson_noise(img, scale, gray_noise, poisson_fields(img.shape, generator, img.device),
                         poisson_fields((n, 1, h, w), generator, img.device))


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0., clip=True, rounds=False,
                             generator=None):
    """``img`` plus Poisson noise of a per-sample scale drawn from
    ``scale_range``, gray with probability ``gray_prob``."""
    n = img.shape[0]
    scale = torch.empty(n, device=img.device).uniform_(*scale_range, generator=generator)
    gray = (torch.rand(n, device=img.device, generator=generator) < gray_prob).float()
    return _clip_round(img + generate_poisson_noise(img, scale, gray, generator), clip, rounds)

