"""StyleGAN2's generator with the FIR resampling replaced by interpolation
(counterpart of ``basicsr4rs_tpu/archs/stylegan2_bilinear_arch.py``;
reference: basicsr/archs/stylegan2_bilinear_arch.py).

An upsampling or downsampling modulated convolution interpolates its input
by 2 or 1/2 first (``interpolation_mode``: bilinear without antialiasing,
or nearest by the JAX package's index rule ``floor(dst * in / out)``),
then runs as a stride-1 one; no FIR smoothing, no transposed convolution.
Names and the JAX key rules as ``stylegan2_arch``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_act import FusedLeakyReLU
from ..utils.registry import ARCH_REGISTRY
from .hifacegan_util import nearest_resize_to
from .stylegan2_arch import (STYLEGAN2_JAX_KEY_RULES, ConstantInput, EqualConv2d, EqualLinear,
                             ScaledLeakyReLU, StyleGAN2Base, draw_noise, modulated_weight,
                             per_sample_conv, stylegan2_channels)


def interpolate(x: torch.Tensor, scale: float, mode: str) -> torch.Tensor:
    """``x`` resized to ``int(size * scale)``."""
    th, tw = int(x.shape[2] * scale), int(x.shape[3] * scale)
    if mode == 'nearest':
        return nearest_resize_to(x, (th, tw))
    return F.interpolate(x, size=(th, tw), mode=mode, align_corners=False)


class Interpolate(nn.Module):

    def __init__(self, scale: float, mode: str):
        super().__init__()
        self.scale, self.mode = scale, mode

    def forward(self, x):
        return interpolate(x, self.scale, self.mode)


class ModulatedConv2dBilinear(nn.Module):
    """Interpolate (when ``sample_mode``), then a stride-1 modulated
    convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True, sample_mode: Optional[str] = None,
                 eps: float = 1e-8, interpolation_mode: str = 'bilinear'):
        super().__init__()
        if sample_mode not in ('upsample', 'downsample', None):
            raise ValueError(f"Wrong sample mode {sample_mode}, supported ones are "
                             "['upsample', 'downsample', None].")
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.eps = eps
        self.interpolation_mode = interpolation_mode
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.modulation = EqualLinear(num_style_feat, in_channels, bias=True, bias_init_val=1,
                                      lr_mul=1, activation=None)
        self.weight = nn.Parameter(torch.randn(1, out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.padding = kernel_size // 2

    def forward(self, x, style):
        weight = modulated_weight(self.scale * self.weight, self.modulation(style),
                                  self.demodulate, self.eps)
        if self.sample_mode == 'upsample':
            x = interpolate(x, 2., self.interpolation_mode)
        elif self.sample_mode == 'downsample':
            x = interpolate(x, 0.5, self.interpolation_mode)
        return per_sample_conv(x, weight, padding=self.padding)


class StyleConvBilinear(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True, sample_mode: Optional[str] = None,
                 interpolation_mode: str = 'bilinear'):
        super().__init__()
        self.modulated_conv = ModulatedConv2dBilinear(
            in_channels, out_channels, kernel_size, num_style_feat, demodulate, sample_mode,
            interpolation_mode=interpolation_mode)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None, generator=None):
        out = self.modulated_conv(x, style)
        if noise is None:
            noise = draw_noise(out, generator)
        return self.activate(out + self.weight * noise)


class ToRGBBilinear(nn.Module):

    def __init__(self, in_channels: int, num_style_feat: int, upsample: bool = True,
                 interpolation_mode: str = 'bilinear'):
        super().__init__()
        self.upsample = upsample
        self.interpolation_mode = interpolation_mode
        self.modulated_conv = ModulatedConv2dBilinear(
            in_channels, 3, 1, num_style_feat, demodulate=False, sample_mode=None,
            interpolation_mode=interpolation_mode)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = interpolate(skip, 2., self.interpolation_mode)
            out = out + skip
        return out


@ARCH_REGISTRY.register()
class StyleGAN2GeneratorBilinear(StyleGAN2Base):

    JAX_KEY_RULES = STYLEGAN2_JAX_KEY_RULES

    def __init__(self, out_size: int, num_style_feat: int = 512, num_mlp: int = 8,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01, narrow: float = 1,
                 interpolation_mode: str = 'bilinear'):
        super().__init__()
        self._build_style_mlp(out_size, num_style_feat, num_mlp, lr_mlp)
        channels = stylegan2_channels(channel_multiplier, narrow)
        self.channels = channels
        self.constant_input = ConstantInput(channels['4'], size=4)
        self.style_conv1 = StyleConvBilinear(channels['4'], channels['4'], 3, num_style_feat,
                                             interpolation_mode=interpolation_mode)
        self.to_rgb1 = ToRGBBilinear(channels['4'], num_style_feat, upsample=False,
                                     interpolation_mode=interpolation_mode)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channels = channels['4']
        for i in range(3, self.log_size + 1):
            out_channels = channels[f'{2**i}']
            self.style_convs.append(StyleConvBilinear(in_channels, out_channels, 3,
                                                      num_style_feat, sample_mode='upsample',
                                                      interpolation_mode=interpolation_mode))
            self.style_convs.append(StyleConvBilinear(out_channels, out_channels, 3,
                                                      num_style_feat, sample_mode=None,
                                                      interpolation_mode=interpolation_mode))
            self.to_rgbs.append(ToRGBBilinear(out_channels, num_style_feat, upsample=True,
                                              interpolation_mode=interpolation_mode))
            in_channels = out_channels


class ConvLayerBilinear(nn.Sequential):
    """[a 1/2 interpolation when ``downsample``], a stride-1 EqualConv2d,
    and a fused leaky ReLU (``bias``) or a scaled one."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 downsample: bool = False, bias: bool = True, activate: bool = True,
                 interpolation_mode: str = 'bilinear'):
        layers = [Interpolate(0.5, interpolation_mode)] if downsample else []
        layers.append(EqualConv2d(in_channels, out_channels, kernel_size, stride=1,
                                  padding=kernel_size // 2, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias else ScaledLeakyReLU(0.2))
        super().__init__(*layers)


class ResBlockBilinear(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, interpolation_mode: str = 'bilinear'):
        super().__init__()
        self.conv1 = ConvLayerBilinear(in_channels, in_channels, 3, bias=True, activate=True)
        self.conv2 = ConvLayerBilinear(in_channels, out_channels, 3, downsample=True,
                                       interpolation_mode=interpolation_mode)
        self.skip = ConvLayerBilinear(in_channels, out_channels, 1, downsample=True, bias=False,
                                      activate=False, interpolation_mode=interpolation_mode)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)
