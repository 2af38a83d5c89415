"""MATLAB's bicubic ``imresize`` in float64 numpy (counterpart of
``basicsr4rs_tpu/utils/matlab_functions.py``; reference:
basicsr/utils/matlab_functions.py). A host function, used by NIQE.

For each output coordinate: map to the input with ``u = x / scale + 0.5 (1 -
1 / scale)``, take ``ceil(kernel width) + 2`` taps around it, weight them with
Keys' cubic (a = -0.5), stretched by the scale when a downscale is
antialiased, normalise the weights to sum 1, and mirror indices past the
borders. Separable: rows, then columns.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cubic(x: np.ndarray) -> np.ndarray:
    """Keys' bicubic convolution kernel with a = -0.5 (MATLAB's)."""
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    inner = (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1)
    outer = (-0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0) * ((absx > 1) & (absx <= 2))
    return inner + outer


def calculate_weights_indices(in_length: int, out_length: int, scale: float,
                              kernel_width: float = 4.0,
                              antialiasing: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(weights, indices), each (out_length, P), of one axis: all-zero
    columns trimmed, indices mirrored into range."""
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale   # a low-pass filter when shrinking

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)   # 1-based, MATLAB's convention
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    weights = scale * cubic(dist * scale) if scale < 1 and antialiasing else cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    nz = np.nonzero(np.any(np.abs(weights) > 1e-12, axis=0))[0]
    weights = weights[:, nz[0]:nz[-1] + 1]
    indices = indices[:, nz[0]:nz[-1] + 1]

    aux = np.concatenate([np.arange(in_length), np.arange(in_length)[::-1]])
    indices = aux[np.mod(indices.astype(np.int64) - 1, 2 * in_length)]
    return weights, indices


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """Bicubic resize of an HW or HWC float image to ``ceil(size * scale)``;
    float64 out, the same layout."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, _ = img.shape
    out_h, out_w = int(np.ceil(in_h * scale)), int(np.ceil(in_w * scale))
    img = img.astype(np.float64)
    weights_h, indices_h = calculate_weights_indices(in_h, out_h, scale, 4.0, antialiasing)
    weights_w, indices_w = calculate_weights_indices(in_w, out_w, scale, 4.0, antialiasing)
    tmp = np.einsum('op,opwc->owc', weights_h, img[indices_h])
    out = np.einsum('op,hopc->hoc', weights_w, tmp[:, indices_w])
    return out[:, :, 0] if squeeze else out


def imresize_uint8(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """uint8 in, uint8 out: rounded and clipped as MATLAB does."""
    out = imresize(img.astype(np.float64) / 255.0, scale, antialiasing)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
