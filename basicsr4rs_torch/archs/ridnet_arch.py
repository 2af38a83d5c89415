"""RIDNet, real image denoising with feature attention (counterpart of
``basicsr4rs_tpu/archs/ridnet_arch.py``; reference:
basicsr/archs/ridnet_arch.py).

A mean shift (a trainable 1x1 conv that starts as the shift), a head conv,
``num_block`` enhancement attention modules (two dilated branches merged,
a residual block, an enhanced residual block, channel attention), a tail
conv, the shift back, and the input added. BasicSR's key names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import ChannelAttention, ResidualBlockNoBN, make_layer


class MeanShift(nn.Conv2d):
    """A 1x1 conv that starts as ``(x + sign * rgb_range * mean) / std``
    per channel; trainable, as in the reference."""

    def __init__(self, rgb_range: float, rgb_mean: Sequence[float], rgb_std: Sequence[float],
                 sign: int = -1):
        super().__init__(3, 3, kernel_size=1)
        std = torch.tensor(rgb_std, dtype=torch.float32)
        with torch.no_grad():
            self.weight.copy_(torch.eye(3).view(3, 3, 1, 1) / std.view(3, 1, 1, 1))
            self.bias.copy_(sign * rgb_range * torch.tensor(rgb_mean, dtype=torch.float32) / std)


class EResidualBlockNoBN(nn.Module):
    """conv, ReLU, conv, ReLU, 1x1 conv; the input added, then a ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(in_channels, out_channels, 3, 1, 1), nn.ReLU(),
                                  nn.Conv2d(out_channels, out_channels, 3, 1, 1), nn.ReLU(),
                                  nn.Conv2d(out_channels, out_channels, 1, 1, 0))

    def forward(self, x):
        return F.relu(self.body(x) + x)


class MergeRun(nn.Module):
    """Two branches of dilated convs (dilations 1, 2 and 3, 4) side by side,
    aggregated by a conv, the input added."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.dilation1 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 2, 2), nn.ReLU())
        self.dilation2 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 3, 3), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 4, 4), nn.ReLU())
        self.aggregation = nn.Sequential(nn.Conv2d(out_channels * 2, out_channels, 3, 1, 1),
                                         nn.ReLU())

    def forward(self, x):
        out = torch.cat([self.dilation1(x), self.dilation2(x)], dim=1)
        return self.aggregation(out) + x


class EAM(nn.Module):
    """Enhancement attention module."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 squeeze_factor: int = 16):
        super().__init__()
        self.merge = MergeRun(in_channels, mid_channels)
        self.block1 = ResidualBlockNoBN(mid_channels)
        self.block2 = EResidualBlockNoBN(mid_channels, out_channels)
        self.ca = ChannelAttention(out_channels, squeeze_factor)

    def forward(self, x):
        out = F.relu(self.block1(self.merge(x)))
        return self.ca(self.block2(out))


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):

    JAX_KEY_RULES = ChannelAttention.JAX_KEY_RULES

    def __init__(self, in_channels: int = 3, mid_channels: int = 64, out_channels: int = 3,
                 num_block: int = 4, img_range: float = 255.,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040),
                 rgb_std: Sequence[float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std, -1)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = nn.Conv2d(in_channels, mid_channels, 3, 1, 1)
        self.body = make_layer(EAM, num_block, in_channels=mid_channels,
                               mid_channels=mid_channels, out_channels=mid_channels)
        self.tail = nn.Conv2d(mid_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = F.relu(self.head(self.sub_mean(x)))
        res = self.add_mean(self.tail(self.body(res)))
        return x + res
