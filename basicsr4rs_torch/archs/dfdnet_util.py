"""DFDNet's blocks (counterpart of ``basicsr4rs_tpu/archs/dfdnet_util.py``;
reference: basicsr/archs/dfdnet_util.py).

NCHW; the Sequential indices are BasicSR's. The reference's ``Blur`` is a
custom autograd function for its backward's memory only: here it is the
depthwise 3x3 binomial convolution itself. Spectral convolutions are
``hifacegan_util.SNConv2d`` (the exact norm).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .hifacegan_util import SNConv2d

_BLUR_KERNEL = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]) / 16.


def blur(x: torch.Tensor) -> torch.Tensor:
    """3x3 binomial depthwise blur, padding 1."""
    c = x.shape[1]
    return F.conv2d(x, _BLUR_KERNEL.to(x)[None, None].expand(c, 1, 3, 3), padding=1, groups=c)


class Blur(nn.Module):

    def forward(self, x):
        return blur(x)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Mean and standard deviation (unbiased variance, plus ``eps``) over
    (H, W), each (N, C, 1, 1)."""
    n, c, h, w = feat.shape
    var, mean = torch.var_mean(feat.reshape(n, c, h * w), dim=2, unbiased=False)
    var = var * (h * w) / max(h * w - 1, 1)
    return mean.view(n, c, 1, 1), torch.sqrt(var + eps).view(n, c, 1, 1)


def adaptive_instance_normalization(content_feat: torch.Tensor,
                                    style_feat: torch.Tensor) -> torch.Tensor:
    """AdaIN: the content features with the style features' mean and std."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    return (content_feat - content_mean) / content_std * style_std + style_mean


def AttentionBlock(in_channel: int) -> nn.Sequential:   # noqa: N802 (BasicSR's name)
    return nn.Sequential(SNConv2d(in_channel, in_channel, 3, 1, 1), nn.LeakyReLU(0.2),
                         SNConv2d(in_channel, in_channel, 3, 1, 1))


class MSDilationBlock(nn.Module):
    """Four dilated SNConv-lrelu-SNConv branches, concatenated, fused by a
    spectral convolution, plus the input."""

    def __init__(self, in_channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 1, 1, 1), bias: bool = True):
        super().__init__()
        self.conv_blocks = nn.ModuleList()
        for i in range(4):
            pad = ((kernel_size - 1) // 2) * dilation[i]
            self.conv_blocks.append(nn.Sequential(
                SNConv2d(in_channels, in_channels, kernel_size, 1, pad, bias, dilation[i]),
                nn.LeakyReLU(0.2),
                SNConv2d(in_channels, in_channels, kernel_size, 1, pad, bias, dilation[i])))
        self.conv_fusion = SNConv2d(in_channels * 4, in_channels, kernel_size, 1,
                                    (kernel_size - 1) // 2, bias)

    def forward(self, x):
        out = torch.cat([block(x) for block in self.conv_blocks], dim=1)
        return self.conv_fusion(out) + x


class UpResBlock(nn.Module):

    def __init__(self, in_channel: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(in_channel, in_channel, 3, 1, 1), nn.LeakyReLU(0.2),
                                  nn.Conv2d(in_channel, in_channel, 3, 1, 1))

    def forward(self, x):
        return x + self.body(x)
