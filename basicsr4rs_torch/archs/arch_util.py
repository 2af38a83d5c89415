"""Shared architecture building blocks (counterpart of
``basicsr4rs_tpu/archs/arch_util.py``; reference: basicsr/archs/arch_util.py).
NCHW, BasicSR's module and key layout."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def trunc_normal_(tensor: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], as the JAX package's
    ``trunc_normal_init``."""
    return nn.init.trunc_normal_(tensor, 0., std, -2 * std, 2 * std, generator=generator)


def default_conv_init_(conv: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    """torch's own ``Conv2d.reset_parameters`` distribution, from ``generator``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
    if conv.bias is not None:
        fan_in = conv.weight[0].numel()
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


class Upsample(nn.Sequential):
    """Pixel-shuffle upsampler for scales 2^n and 3: (conv, PixelShuffle)
    per stage, so the convs are keys ``0``, ``2``, ..."""

    def __init__(self, scale: int, num_feat: int):
        m = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                m += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        elif scale == 3:
            m += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} is not supported. Supported scales: 2^n and 3.')
        super().__init__(*m)


class UpsampleOneStep(nn.Sequential):
    """One conv and one pixel shuffle (the lightweight SR upsampler)."""

    def __init__(self, scale: int, num_feat: int, num_out_ch: int):
        super().__init__(nn.Conv2d(num_feat, scale**2 * num_out_ch, 3, 1, 1),
                         nn.PixelShuffle(scale))
