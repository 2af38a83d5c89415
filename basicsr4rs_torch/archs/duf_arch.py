"""DUF, video SR by dynamic upsampling filters (counterpart of
``basicsr4rs_tpu/archs/duf_arch.py``; reference: basicsr/archs/duf_arch.py).
Clips (N, 7, 3, H, W); BasicSR's module and key layout.

3-D convolutions over (time, height, width) with pre-activation BatchNorm
(``arch_util.BatchNorm3d``: Flax's running statistics, eps 1e-3 under
``adapt_official_weights`` and Flax's momentum, as in the JAX package)
reduce the seven frames to one map, from which come a residual image and,
for every LQ pixel and each of the scale**2 sub-pixels, a softmax over a
5x5 neighbourhood of the centre frame. No kernel of the port runs here:
cuDNN's 3-D convolutions and ``F.unfold``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import BatchNorm3d


def _dense_unit(channels: int, num_grow_ch: int, eps: float, time_padding: int) -> nn.Sequential:
    """BatchNorm, ReLU, 1x1x1 conv, BatchNorm, ReLU, 3x3x3 conv to
    ``num_grow_ch`` channels (padded by ``time_padding`` in time, 1 in
    space)."""
    return nn.Sequential(
        BatchNorm3d(channels, eps=eps), nn.ReLU(inplace=True),
        nn.Conv3d(channels, channels, 1, 1, 0, bias=True),
        BatchNorm3d(channels, eps=eps), nn.ReLU(inplace=True),
        nn.Conv3d(channels, num_grow_ch, 3, 1, (time_padding, 1, 1), bias=True))


class DenseBlocks(nn.Module):
    """``num_block`` dense units at the same length in time; x (B, C, T, H, W)
    grows by ``num_grow_ch`` channels a unit."""

    def __init__(self, num_block: int, num_feat: int = 64, num_grow_ch: int = 16,
                 eps: float = 1e-5):
        super().__init__()
        self.dense_blocks = nn.ModuleList(
            [_dense_unit(num_feat + i * num_grow_ch, num_grow_ch, eps, 1)
             for i in range(num_block)])

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat((x, block(x)), 1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    """Three dense units, each valid in time: T shrinks by 2 a unit (7 -> 1)."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32, eps: float = 1e-5):
        super().__init__()
        self.temporal_reduce1 = _dense_unit(num_feat, num_grow_ch, eps, 0)
        self.temporal_reduce2 = _dense_unit(num_feat + num_grow_ch, num_grow_ch, eps, 0)
        self.temporal_reduce3 = _dense_unit(num_feat + 2 * num_grow_ch, num_grow_ch, eps, 0)

    def forward(self, x):
        for unit in (self.temporal_reduce1, self.temporal_reduce2, self.temporal_reduce3):
            x = torch.cat((x[:, :, 1:-1], unit(x)), 1)
        return x


def dynamic_upsampling_filter(x: torch.Tensor, filters: torch.Tensor,
                              filter_size=(5, 5)) -> torch.Tensor:
    """Per-pixel filters applied to their neighbourhoods.

    Args:
      x: the centre frame (N, C, H, W).
      filters: (N, kh * kw, U, H, W), U outputs a pixel, each a filter over
        the kh x kw neighbourhood (zero outside the frame).
    Returns (N, C * U, H, W), channel c * U + u.
    """
    n, c, h, w = x.shape
    kh, kw = filter_size
    taps = kh * kw
    patches = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2)).view(n, c, taps, h * w)
    out = torch.einsum('nckp,nkup->ncup', patches, filters.reshape(n, taps, -1, h * w))
    return out.reshape(n, -1, h, w)


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """(N, 7, 3, H, W) -> (N, 3, scale * H, scale * W), the centre frame.
    ``num_layer``: 16, 28 or 52."""

    JAX_KEY_RULES = ()   # the general rules of utils.jax_convert suffice

    def __init__(self, scale: int = 4, num_layer: int = 52, adapt_official_weights: bool = False):
        super().__init__()
        self.scale = scale
        eps = 1e-3 if adapt_official_weights else 1e-5
        blocks = {16: (3, 32), 28: (9, 16), 52: (21, 16)}
        if num_layer not in blocks:
            raise ValueError(f'Only supported (16, 28, 52) layers, but got {num_layer}.')
        num_block, num_grow_ch = blocks[num_layer]
        self.conv3d1 = nn.Conv3d(3, 64, (1, 3, 3), 1, (0, 1, 1), bias=True)
        self.dense_block1 = DenseBlocks(num_block, 64, num_grow_ch, eps)
        self.dense_block2 = DenseBlocksTemporalReduce(64 + num_grow_ch * num_block, num_grow_ch,
                                                      eps)
        channels = 64 + num_grow_ch * num_block + num_grow_ch * 3
        self.bn3d2 = BatchNorm3d(channels, eps=eps)
        self.conv3d2 = nn.Conv3d(channels, 256, (1, 3, 3), 1, (0, 1, 1), bias=True)
        self.conv3d_r1 = nn.Conv3d(256, 256, 1, 1, 0, bias=True)
        self.conv3d_r2 = nn.Conv3d(256, 3 * scale**2, 1, 1, 0, bias=True)
        self.conv3d_f1 = nn.Conv3d(256, 512, 1, 1, 0, bias=True)
        self.conv3d_f2 = nn.Conv3d(512, 25 * scale**2, 1, 1, 0, bias=True)

    def forward(self, x):
        b, t, c, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4)   # (b, c, t, h, w) for the 3-D convolutions
        x_center = x[:, :, t // 2]
        feat = self.dense_block2(self.dense_block1(self.conv3d1(x)))
        feat = F.relu(self.conv3d2(F.relu(self.bn3d2(feat))))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(feat)))[:, :, 0]
        filters = self.conv3d_f2(F.relu(self.conv3d_f1(feat)))[:, :, 0]
        filters = F.softmax(filters.view(b, 25, self.scale**2, h, w), dim=1)
        out = dynamic_upsampling_filter(x_center, filters, (5, 5)) + res
        return F.pixel_shuffle(out, self.scale)
