"""Differentiable JPEG (counterpart of ``basicsr4rs_tpu/utils/diffjpeg.py``;
reference: basicsr/utils/diffjpeg.py).

``DiffJPEG`` round-trips an NCHW RGB batch in [0, 1] through JPEG at a
per-sample quality: padding to multiples of 16, RGB -> YCbCr (the JPEG
matrix), 2x2 chroma averaging, the 8x8 DCT-II as one matmul over the
blocks, quantisation by the standard tables scaled by the quality factor
(``round`` or the differentiable ``diff_round``), and back: the inverse DCT,
nearest chroma upsampling, YCbCr -> RGB, a clip to [0, 255] and the crop.
``add_jpg_compression`` is real JPEG by cv2 on the host.
"""

from __future__ import annotations

import itertools

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The standard tables, stored transposed as upstream DiffJPEG stores them.
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                            [47, 66, 99, 99]], dtype=np.float32)

# DCT-II basis as a (64, 64) matrix: row (x, y), column (u, v) holds
# cos((2x+1)u pi/16) cos((2y+1)v pi/16); the inverse is its transpose
_DCT = np.zeros((8, 8, 8, 8), dtype=np.float32)
for x, y, u, v in itertools.product(range(8), repeat=4):
    _DCT[x, y, u, v] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos((2 * y + 1) * v * np.pi / 16)
_DCT = _DCT.reshape(64, 64)
_IDCT = np.ascontiguousarray(_DCT.T)
_ALPHA = np.array([1. / np.sqrt(2)] + [1.] * 7, dtype=np.float32)
_ALPHA_OUTER = np.outer(_ALPHA, _ALPHA)
_DCT_SCALE = _ALPHA_OUTER * 0.25

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], dtype=np.float32).T
_YCBCR_SHIFT = np.array([0., 128., 128.], dtype=np.float32)
_YCBCR2RGB = np.array([[1., 0., 1.402],
                       [1., -0.344136, -0.714136],
                       [1., 1.772, 0.]], dtype=np.float32).T


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """Differentiable rounding: round(x) + (x - round(x))^3."""
    return torch.round(x) + torch.pow(x - torch.round(x), 3)


def quality_to_factor(quality):
    """JPEG quality (1..100) -> the tables' scale factor."""
    quality = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(quality < 50, 5000. / quality, 200. - quality * 2) / 100.


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H/8 * W/8, 64), blocks in row-major order."""
    n, h, w = x.shape
    return x.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(n, -1, 64)


def _from_blocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = x.shape[0]
    return x.reshape(n, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, h, w)


class DiffJPEG(nn.Module):
    """JPEG round trip of an NCHW RGB batch in [0, 1] at ``quality``
    (scalar or (N,)); ``differentiable`` picks ``diff_round`` over
    ``round``."""

    def __init__(self, differentiable: bool = True):
        super().__init__()
        self.rounding = diff_round if differentiable else torch.round
        for name, value in (('y_table', Y_TABLE), ('c_table', C_TABLE), ('dct', _DCT),
                            ('idct', _IDCT), ('dct_scale', _DCT_SCALE),
                            ('alpha_outer', _ALPHA_OUTER), ('rgb2ycbcr', _RGB2YCBCR),
                            ('ycbcr_shift', _YCBCR_SHIFT), ('ycbcr2rgb', _YCBCR2RGB)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(value)),
                                 persistent=False)

    def forward(self, x: torch.Tensor, quality) -> torch.Tensor:
        n, _, h, w = x.shape
        factor = quality_to_factor(quality).to(x.device)
        factor = factor.expand(n).reshape(n, 1, 1) if factor.dim() == 0 else factor.reshape(n, 1, 1)

        h_pad, w_pad = (16 - h % 16) % 16, (16 - w % 16) % 16
        hp, wp = h + h_pad, w + w_pad
        img = F.pad(x, (0, w_pad, 0, h_pad)).float().permute(0, 2, 3, 1) * 255.
        ycbcr = img @ self.rgb2ycbcr + self.ycbcr_shift
        y, cb, cr = ycbcr.unbind(-1)

        def sub(c):   # 2x2 chroma averaging
            return c.reshape(n, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))

        def compress(comp, table):
            blocks = ((_to_blocks(comp) - 128.) @ self.dct) * self.dct_scale.reshape(64)
            return self.rounding(blocks / (table.reshape(64) * factor))

        def decompress(codes, table, hh, ww):
            blocks = (codes * (table.reshape(64) * factor)) * self.alpha_outer.reshape(64)
            return _from_blocks(0.25 * (blocks @ self.idct) + 128., hh, ww)

        y_r = decompress(compress(y, self.y_table), self.y_table, hp, wp)
        cb_r, cr_r = (decompress(compress(sub(c), self.c_table), self.c_table, hp // 2, wp // 2)
                      for c in (cb, cr))

        def up(c):   # nearest chroma upsampling
            return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        ycbcr_r = torch.stack([y_r, up(cb_r), up(cr_r)], dim=-1)
        rgb = (ycbcr_r - self.ycbcr_shift) @ self.ycbcr2rgb
        rgb = torch.clamp(rgb, 0, 255) / 255.
        return rgb[:, :h, :w, :].permute(0, 3, 1, 2).contiguous()


def add_jpg_compression(img: np.ndarray, quality: int = 90) -> np.ndarray:
    """Real JPEG of an HWC [0, 1] float image by cv2 at ``quality``."""
    encode_param = [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    _, encimg = cv2.imencode('.jpg', (img * 255.).clip(0, 255).astype(np.uint8), encode_param)
    return np.float32(cv2.imdecode(encimg, 1)) / 255.
