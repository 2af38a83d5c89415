"""StyleGAN2's generator and discriminator (counterpart of
``basicsr4rs_tpu/archs/stylegan2_arch.py``; reference:
basicsr/archs/stylegan2_arch.py).

NCHW, with BasicSR's modules and key names (``constant_input.weight``, a
modulated convolution's ``weight`` of (1, out, in, k, k), a StyleConv's
noise ``weight``); ``JAX_KEY_RULES`` turns the JAX package's names for
those three (``const``, ``w_mod``, ``noise_weight``) into them. The
resampling FIR kernels are non-persistent buffers under BasicSR's names,
so a BasicSR checkpoint's copies of them are read and dropped.

The per-sample modulated convolution is the grouped ``F.conv2d`` /
``F.conv_transpose2d`` with ``groups = batch``, the form BasicSR uses and
the JAX package imitates with ``batch_group_count``. Where the JAX package
differs from BasicSR the port follows it: two style codes mix at
``num_latent // 2`` unless ``inject_index`` is given (BasicSR draws it),
the stored noise buffers start at zero, the minibatch-stddev group is
``min(batch, stddev_group)``. Noise that the generator draws itself
(``noise=None``, ``randomize_noise``) comes from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_act import FusedLeakyReLU, fused_leaky_relu, scaled_leaky_relu
from ..ops.upfirdn2d import make_resample_kernel, upfirdn_smooth, upfirdn_upsample
from ..utils.dist_util import all_gather_rows, get_dist_info
from ..utils.registry import ARCH_REGISTRY

# the JAX package's leaf names for the three parameters it lays out as torch does
STYLEGAN2_JAX_KEY_RULES = (
    (r'modulated_conv\.w_mod$', 'modulated_conv.weight'),
    (r'\.noise_weight$', '.weight'),
    (r'^const$', 'constant_input.weight'),
)


def normalize_style_code(x: torch.Tensor) -> torch.Tensor:
    """x / rms(x) over the features."""
    return x * torch.rsqrt(x.pow(2).mean(dim=1, keepdim=True) + 1e-8)


class NormStyleCode(nn.Module):

    def forward(self, x):
        return normalize_style_code(x)


class UpFirDnUpsample(nn.Module):
    """x2 (``factor``) FIR upsampling, its kernel scaled by ``factor ** 2``."""

    def __init__(self, resample_kernel: Sequence[int], factor: int = 2):
        super().__init__()
        self.factor = factor
        self.register_buffer('kernel', make_resample_kernel(resample_kernel), persistent=False)

    def forward(self, x):
        return upfirdn_upsample(x, self.kernel, self.factor)


class UpFirDnSmooth(nn.Module):
    """The FIR smoothing after a x2 transposed convolution or before a
    stride-2 one of ``kernel_size``."""

    def __init__(self, resample_kernel: Sequence[int], upsample_factor: int = 1,
                 downsample_factor: int = 1, kernel_size: int = 1):
        super().__init__()
        self.upsample_factor, self.downsample_factor = upsample_factor, downsample_factor
        self.kernel_size = kernel_size
        self.register_buffer('kernel', make_resample_kernel(resample_kernel), persistent=False)

    def forward(self, x):
        return upfirdn_smooth(x, self.kernel, self.upsample_factor, self.downsample_factor,
                              self.kernel_size)


class EqualLinear(nn.Module):
    """A linear layer whose weight (drawn N(0, 1) / lr_mul) is scaled by
    lr_mul / sqrt(in) at run time, and its bias by lr_mul."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 bias_init_val: float = 0., lr_mul: float = 1.,
                 activation: Optional[str] = None):
        super().__init__()
        if activation not in ('fused_lrelu', None):
            raise ValueError(f"Wrong activation value in EqualLinear: {activation}. "
                             "Supported ones are: ['fused_lrelu', None].")
        self.lr_mul = lr_mul
        self.activation = activation
        self.scale = (1 / math.sqrt(in_channels)) * lr_mul
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels).div_(lr_mul))
        self.bias = nn.Parameter(torch.full((out_channels,), float(bias_init_val))) if bias \
            else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == 'fused_lrelu':
            return fused_leaky_relu(F.linear(x, self.weight * self.scale), bias)
        return F.linear(x, self.weight * self.scale, bias)


def modulated_weight(weight: torch.Tensor, style: torch.Tensor, demodulate: bool,
                     eps: float = 1e-8) -> torch.Tensor:
    """The per-sample weight (b, out, in, k, k): ``weight`` (1, out, in, k, k),
    already scaled, times the style (b, in), divided by each output
    filter's norm when ``demodulate``."""
    weight = weight * style[:, None, :, None, None]
    if demodulate:
        weight = weight * torch.rsqrt(weight.pow(2).sum(dim=(2, 3, 4)) + eps)[:, :, None, None,
                                                                              None]
    return weight


def per_sample_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """Sample i of ``x`` (b, in, h, w) convolved with ``weight[i]`` (b, out,
    in, k, k): one grouped convolution of the batch folded into channels."""
    b, cin, h, w = x.shape
    cout, k = weight.shape[1], weight.shape[-1]
    out = F.conv2d(x.reshape(1, b * cin, h, w), weight.reshape(b * cout, cin, k, k),
                   stride=stride, padding=padding, groups=b)
    return out.reshape(b, cout, *out.shape[2:])


class ModulatedConv2d(nn.Module):
    """A style-modulated (and demodulated) convolution; ``sample_mode``
    'upsample' runs it as a stride-2 transposed convolution followed by the
    FIR smoothing, 'downsample' as the smoothing followed by a stride-2
    convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True, sample_mode: Optional[str] = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), eps: float = 1e-8):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.eps = eps
        if sample_mode == 'upsample':
            self.smooth = UpFirDnSmooth(resample_kernel, upsample_factor=2, downsample_factor=1,
                                        kernel_size=kernel_size)
        elif sample_mode == 'downsample':
            self.smooth = UpFirDnSmooth(resample_kernel, upsample_factor=1, downsample_factor=2,
                                        kernel_size=kernel_size)
        elif sample_mode is not None:
            raise ValueError(f"Wrong sample mode {sample_mode}, supported ones are "
                             "['upsample', 'downsample', None].")
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.modulation = EqualLinear(num_style_feat, in_channels, bias=True, bias_init_val=1,
                                      lr_mul=1, activation=None)
        self.weight = nn.Parameter(torch.randn(1, out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.padding = kernel_size // 2

    def forward(self, x, style):
        b, cin, h, w = x.shape
        weight = modulated_weight(self.scale * self.weight, self.modulation(style),
                                  self.demodulate, self.eps)
        if self.sample_mode == 'upsample':
            k = self.kernel_size
            # transposed: per group the weight is (in, out, k, k)
            wt = weight.transpose(1, 2).reshape(b * cin, self.out_channels, k, k)
            out = F.conv_transpose2d(x.reshape(1, b * cin, h, w), wt, stride=2, groups=b)
            return self.smooth(out.reshape(b, self.out_channels, *out.shape[2:]))
        if self.sample_mode == 'downsample':
            return per_sample_conv(self.smooth(x), weight, stride=2)
        return per_sample_conv(x, weight, padding=self.padding)


def draw_noise(out: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """(b, 1, h, w) of N(0, 1) for the map ``out``, from ``generator``."""
    b, _, h, w = out.shape
    return torch.randn((b, 1, h, w), generator=generator, device=out.device, dtype=out.dtype)


class StyleConv(nn.Module):
    """Modulated convolution, per-pixel noise scaled by a learnt ``weight``,
    fused leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_style_feat: int, demodulate: bool = True, sample_mode: Optional[str] = None,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(in_channels, out_channels, kernel_size,
                                              num_style_feat, demodulate, sample_mode,
                                              resample_kernel)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None, generator=None):
        out = self.modulated_conv(x, style)
        if noise is None:
            noise = draw_noise(out, generator)
        return self.activate(out + self.weight * noise)


class ToRGB(nn.Module):
    """A 1x1 modulated convolution to RGB (no demodulation), a bias, and the
    upsampled skip from the coarser level added."""

    def __init__(self, in_channels: int, num_style_feat: int, upsample: bool = True,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        if upsample:
            self.upsample = UpFirDnUpsample(resample_kernel, factor=2)
        else:
            self.upsample = None
        self.modulated_conv = ModulatedConv2d(in_channels, 3, 1, num_style_feat,
                                              demodulate=False, sample_mode=None)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample is not None:
                skip = self.upsample(skip)
            out = out + skip
        return out


class ConstantInput(nn.Module):

    def __init__(self, num_channel: int, size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, num_channel, size, size))

    def forward(self, batch):
        return self.weight.repeat(batch, 1, 1, 1)


def stylegan2_channels(channel_multiplier: float, narrow: float = 1) -> dict:
    return {
        '4': int(512 * narrow), '8': int(512 * narrow), '16': int(512 * narrow),
        '32': int(512 * narrow), '64': int(256 * channel_multiplier * narrow),
        '128': int(128 * channel_multiplier * narrow),
        '256': int(64 * channel_multiplier * narrow),
        '512': int(32 * channel_multiplier * narrow),
        '1024': int(16 * channel_multiplier * narrow),
    }


class StyleGAN2Base(nn.Module):
    """What both StyleGAN2 generators share: the style MLP, the truncation
    and the mixing of codes into the latent (b, num_latent,
    num_style_feat), the stored noise buffers, and the synthesis loop over
    the subclass's ``constant_input``, ``style_conv1``, ``to_rgb1``,
    ``style_convs`` (pairs) and ``to_rgbs``."""

    def _build_style_mlp(self, out_size: int, num_style_feat: int, num_mlp: int,
                         lr_mlp: float) -> None:
        self.num_style_feat = num_style_feat
        self.log_size = int(math.log(out_size, 2))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        layers = [NormStyleCode()]
        for _ in range(num_mlp):
            layers.append(EqualLinear(num_style_feat, num_style_feat, bias=True, bias_init_val=0,
                                      lr_mul=lr_mlp, activation='fused_lrelu'))
        self.style_mlp = nn.Sequential(*layers)
        self.noises = nn.Module()
        for layer_idx in range(self.num_layers):
            resolution = 2**((layer_idx + 5) // 2)
            self.noises.register_buffer(f'noise{layer_idx}',
                                        torch.zeros(1, 1, resolution, resolution))

    def latents(self, styles, input_is_latent: bool = False, truncation: float = 1.,
                truncation_latent: Optional[torch.Tensor] = None,
                inject_index: Optional[int] = None) -> torch.Tensor:
        """The latent (b, num_latent, F) of one code (or a given latent of
        that shape) or of two codes mixed at ``inject_index``."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
        if len(styles) == 1:
            s = styles[0]
            return s if s.dim() == 3 else s.unsqueeze(1).repeat(1, self.num_latent, 1)
        if inject_index is None:
            inject_index = self.num_latent // 2
        return torch.cat([styles[0].unsqueeze(1).repeat(1, inject_index, 1),
                          styles[1].unsqueeze(1).repeat(1, self.num_latent - inject_index, 1)],
                         dim=1)

    def layer_noise(self, noise, randomize_noise: bool) -> List[Optional[torch.Tensor]]:
        if noise is not None:
            return list(noise)
        if randomize_noise:
            return [None] * self.num_layers
        return [getattr(self.noises, f'noise{i}') for i in range(self.num_layers)]

    def synthesis(self, latent, noise, generator=None):
        out = self.constant_input(latent.shape[0])
        out = self.style_conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for conv1, conv2, noise1, noise2, to_rgb in zip(self.style_convs[::2],
                                                        self.style_convs[1::2], noise[1::2],
                                                        noise[2::2], self.to_rgbs):
            out = conv1(out, latent[:, i], noise1, generator)
            out = conv2(out, latent[:, i + 1], noise2, generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, styles, input_is_latent: bool = False, noise=None,
                randomize_noise: bool = True, truncation: float = 1., truncation_latent=None,
                inject_index: Optional[int] = None, return_latents: bool = False,
                generator: Optional[torch.Generator] = None):
        """(image, latent if ``return_latents`` else None). ``noise``: one
        map (b or 1, 1, h, w) a StyleConv layer, or None each where the
        layer draws its own from ``generator``."""
        latent = self.latents(styles, input_is_latent, truncation, truncation_latent,
                              inject_index)
        image = self.synthesis(latent, self.layer_noise(noise, randomize_noise), generator)
        return image, (latent if return_latents else None)


@ARCH_REGISTRY.register()
class StyleGAN2Generator(StyleGAN2Base):
    """StyleGAN2's generator: style MLP, a 4x4 constant, a StyleConv pair
    and a ToRGB a resolution up to ``out_size``."""

    JAX_KEY_RULES = STYLEGAN2_JAX_KEY_RULES

    def __init__(self, out_size: int, num_style_feat: int = 512, num_mlp: int = 8,
                 channel_multiplier: int = 2, resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01, narrow: float = 1):
        super().__init__()
        self._build_style_mlp(out_size, num_style_feat, num_mlp, lr_mlp)
        channels = stylegan2_channels(channel_multiplier, narrow)
        self.channels = channels
        self.constant_input = ConstantInput(channels['4'], size=4)
        self.style_conv1 = StyleConv(channels['4'], channels['4'], 3, num_style_feat,
                                     demodulate=True, sample_mode=None,
                                     resample_kernel=resample_kernel)
        self.to_rgb1 = ToRGB(channels['4'], num_style_feat, upsample=False,
                             resample_kernel=resample_kernel)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channels = channels['4']
        for i in range(3, self.log_size + 1):
            out_channels = channels[f'{2**i}']
            self.style_convs.append(StyleConv(in_channels, out_channels, 3, num_style_feat,
                                              demodulate=True, sample_mode='upsample',
                                              resample_kernel=resample_kernel))
            self.style_convs.append(StyleConv(out_channels, out_channels, 3, num_style_feat,
                                              demodulate=True, sample_mode=None,
                                              resample_kernel=resample_kernel))
            self.to_rgbs.append(ToRGB(out_channels, num_style_feat, upsample=True,
                                      resample_kernel=resample_kernel))
            in_channels = out_channels


class ScaledLeakyReLU(nn.Module):

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return scaled_leaky_relu(x, self.negative_slope)


class EqualConv2d(nn.Module):
    """A convolution whose weight (drawn N(0, 1)) is scaled by
    1 / sqrt(in * k * k) at run time."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, bias_init_val: float = 0.):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.full((out_channels,), float(bias_init_val))) if bias \
            else None

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias, self.stride, self.padding)


class ConvLayer(nn.Sequential):
    """[FIR smoothing when ``downsample``], an EqualConv2d (stride 2 then),
    and a fused leaky ReLU (``bias``) or a scaled one."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 downsample: bool = False, resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 bias: bool = True, activate: bool = True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, upsample_factor=1, downsample_factor=2,
                                        kernel_size=kernel_size))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channels, out_channels, kernel_size, stride=stride,
                                  padding=padding, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias else ScaledLeakyReLU(0.2))
        super().__init__(*layers)


class ResBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, bias=True, activate=True)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel, bias=True, activate=True)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def minibatch_stddev(out: torch.Tensor, stddev_group: int, sync: bool = False) -> torch.Tensor:
    """``out`` with one channel more: the mean over (C, H, W) of the
    standard deviation across each group of ``min(b, stddev_group)``
    samples strided b / group apart. With ``sync`` the groups are those of
    the global batch (the ranks' rows in rank order, equal on every rank,
    gathered with ``all_gather_rows``), as over the JAX mesh's sharded
    batch, and each rank keeps its own rows' channel."""
    b, c, h, w = out.shape
    full = all_gather_rows(out) if sync else out
    group = min(full.shape[0], stddev_group)
    stddev = full.reshape(group, -1, c, h, w)
    stddev = torch.sqrt(stddev.var(dim=0, unbiased=False) + 1e-8).mean(dim=(1, 2, 3))
    stddev = stddev.reshape(-1, 1, 1, 1).repeat(group, 1, h, w)
    if sync:
        rank = get_dist_info()[0]
        stddev = stddev[rank * b:(rank + 1) * b]
    return torch.cat([out, stddev], dim=1)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """A 1x1 ConvLayer, ResBlocks down to 4x4, the minibatch stddev, a 3x3
    ConvLayer and two EqualLinears on the map flattened in NCHW order. In
    training on several ranks (``sync_ranks``) the stddev groups are the
    global batch's."""

    sync_ranks = False

    def __init__(self, out_size: int, channel_multiplier: int = 2,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1), stddev_group: int = 4,
                 narrow: float = 1):
        super().__init__()
        channels = stylegan2_channels(channel_multiplier, narrow)
        log_size = int(math.log(out_size, 2))
        conv_body = [ConvLayer(3, channels[f'{out_size}'], 1)]
        in_channels = channels[f'{out_size}']
        for i in range(log_size, 2, -1):
            out_channels = channels[f'{2**(i - 1)}']
            conv_body.append(ResBlock(in_channels, out_channels, resample_kernel))
            in_channels = out_channels
        self.conv_body = nn.Sequential(*conv_body)
        self.final_conv = ConvLayer(in_channels + 1, channels['4'], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels['4'] * 4 * 4, channels['4'], bias=True, bias_init_val=0,
                        lr_mul=1, activation='fused_lrelu'),
            EqualLinear(channels['4'], 1, bias=True, bias_init_val=0, lr_mul=1, activation=None))
        self.stddev_group = stddev_group

    def forward(self, x):
        out = minibatch_stddev(self.conv_body(x), self.stddev_group,
                               sync=self.training and self.sync_ranks)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(out.shape[0], -1))
