"""Shared architecture building blocks (counterpart of
``basicsr4rs_tpu/archs/arch_util.py``; reference: basicsr/archs/arch_util.py).
NCHW, BasicSR's module and key layout."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(tensor: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], as the JAX package's
    ``trunc_normal_init``."""
    return nn.init.trunc_normal_(tensor, 0., std, -2 * std, 2 * std, generator=generator)


def default_conv_init_(conv: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """torch's own ``reset_parameters`` distribution of a ``Conv2d`` (and of
    a ``Conv1d`` or ``Linear``, which share it), from ``generator``."""
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


def resize_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsample of NCHW (each pixel repeated)."""
    return F.interpolate(x, scale_factor=scale, mode='nearest')


def resize_bicubic(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of NCHW to ``int(size * scale)``: torch's own bicubic
    (a = -0.75, border clamp, no antialiasing), which the JAX package's
    ``resize_bicubic`` reproduces."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(int(h * scale), int(w * scale)), mode='bicubic',
                         align_corners=align_corners)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C, H*s, W*s) -> (B, C*s*s, H, W), channel-major like torch's
    ``F.pixel_unshuffle``."""
    return F.pixel_unshuffle(x, scale)


def per_level(value, levels: int) -> list:
    """A per-level setting given once for all levels or as a list."""
    return list(value) if isinstance(value, (list, tuple)) else [value] * levels
