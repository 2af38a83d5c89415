"""RCAN, residual channel attention networks (counterpart of
``basicsr4rs_tpu/archs/rcan_arch.py``; reference: basicsr/archs/rcan_arch.py).

``num_group`` residual groups of ``num_block`` RCABs (conv, ReLU, conv,
channel attention, a scaled skip), each group closed by a conv and a skip;
then EDSR's global residual, upsampler and mean shift. BasicSR's module tree
and key names (``rcab.0``, ``rcab.2``, ``rcab.3.attention.1`` ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import ChannelAttention, Upsample, make_layer


class RCAB(nn.Module):
    """Residual channel attention block."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16, res_scale: float = 1.):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(nn.Conv2d(num_feat, num_feat, 3, 1, 1), nn.ReLU(),
                                  nn.Conv2d(num_feat, num_feat, 3, 1, 1),
                                  ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return self.rcab(x) * self.res_scale + x


class ResidualGroup(nn.Module):
    """``num_block`` RCABs and a conv, with a skip over all of them."""

    def __init__(self, num_feat: int, num_block: int, squeeze_factor: int = 16,
                 res_scale: float = 1.):
        super().__init__()
        self.residual_group = make_layer(RCAB, num_block, num_feat=num_feat,
                                         squeeze_factor=squeeze_factor, res_scale=res_scale)
        self.conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return self.conv(self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class RCAN(nn.Module):

    # the JAX RCAB names its layers conv1, conv2 and ca
    JAX_KEY_RULES = ((r'(residual_group\.\d+)\.conv1\.', r'\1.rcab.0.'),
                     (r'(residual_group\.\d+)\.conv2\.', r'\1.rcab.2.'),
                     (r'(residual_group\.\d+)\.ca\.', r'\1.rcab.3.'),
                     *ChannelAttention.JAX_KEY_RULES, *Upsample.JAX_KEY_RULES)

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_group: int = 10, num_block: int = 16, squeeze_factor: int = 16,
                 upscale: int = 4, res_scale: float = 1., img_range: float = 255.,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range = img_range
        self.register_buffer('mean', torch.tensor(rgb_mean, dtype=torch.float32).view(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualGroup, num_group, num_feat=num_feat, num_block=num_block,
                               squeeze_factor=squeeze_factor, res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.mean.to(x.dtype)
        x = self.conv_first((x - mean) * self.img_range)
        res = self.conv_after_body(self.body(x)) + x
        return self.conv_last(self.upsample(res)) / self.img_range + mean
