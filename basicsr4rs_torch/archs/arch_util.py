"""Shared architecture building blocks (counterpart of
``basicsr4rs_tpu/archs/arch_util.py``; reference: basicsr/archs/arch_util.py).
NCHW, BasicSR's module and key layout."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv_fusion_enabled, fused_conv3x3
from ..ops.dcn import bilinear_warp, warp_by_flow


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


@torch.no_grad()
def default_init_weights(module_list, scale: float = 1., bias_fill: float = 0.) -> None:
    """Kaiming-normal weights times ``scale`` and constant biases for every
    convolution and linear layer of the modules (BasicSR's residual-branch
    initialisation)."""
    if not isinstance(module_list, (list, tuple)):
        module_list = [module_list]
    for module in module_list:
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight)
                m.weight.mul_(scale)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)


def make_layer(basic_block: Callable[..., nn.Module], num_basic_block: int,
               **kwarg) -> nn.Sequential:
    """``num_basic_block`` instances of one block in a ``Sequential``."""
    return nn.Sequential(*[basic_block(**kwarg) for _ in range(num_basic_block)])


class ResidualBlockNoBN(nn.Module):
    """conv, ReLU, conv with an identity skip and no normalisation; the
    branch starts at a tenth of the usual scale."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        default_init_weights([self.conv1, self.conv2], 0.1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """Pixel-shuffle upsampler for scales 2^n and 3: (conv, PixelShuffle)
    per stage, so the convs are keys ``0``, ``2``, ... With
    ``SWIN_FUSED_CONV=1`` the convs run through ``fused_conv3x3``."""

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

    def forward(self, x):
        fused = conv_fusion_enabled()
        for module in self:
            if fused and isinstance(module, nn.Conv2d):
                x = fused_conv3x3(x, module.weight, module.bias)
            else:
                x = module(x)
        return x


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


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW without antialiasing, in either corner
    convention."""
    return F.interpolate(x, size=(out_h, out_w), mode='bilinear', align_corners=align_corners)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = 'bilinear',
              padding_mode: str = 'zeros') -> torch.Tensor:
    """Warp a map by an optical flow: output pixel (h, w) is x sampled at
    (w + dx, h + dy), in pixels.

    Args:
      x: (N, C, H, W).
      flow: (N, H, W, 2), last dimension (dx, dy).
      interpolation: 'bilinear' (the deformable sampler with one tap, a CUDA
        kernel on a card) or 'nearest' (plain indexing, no flow gradient).
      padding_mode: 'zeros' (the sampler reads the flow through its strides:
        no grid, no offset tensor), or 'border' (positions clamped to the
        map first, in PyTorch).
    """
    if padding_mode not in ('zeros', 'border'):
        raise ValueError(f'flow_warp: padding_mode {padding_mode!r} is not supported')
    n, _, h, w = x.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f'flow_warp: flow must be {(n, h, w, 2)}, got {tuple(flow.shape)}')
    if interpolation == 'bilinear' and padding_mode == 'zeros':
        return warp_by_flow(x, flow)   # the kernel reads the flow as it is
    grid_y = torch.arange(h, device=x.device, dtype=flow.dtype).view(1, h, 1)
    grid_x = torch.arange(w, device=x.device, dtype=flow.dtype).view(1, 1, w)
    sx = grid_x + flow[..., 0]
    sy = grid_y + flow[..., 1]
    if interpolation == 'bilinear':   # 'border': the clamp, with its gradient rule, in PyTorch
        return bilinear_warp(x, sy, sx, border=True)
    if interpolation != 'nearest':
        raise ValueError(f'flow_warp: interpolation {interpolation!r} is not supported')
    ix, iy = torch.round(sx).long(), torch.round(sy).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    index = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).view(n, 1, h * w)
    out = torch.gather(x.reshape(n, -1, h * w), 2, index.expand(-1, x.shape[1], -1)).view_as(x)
    if padding_mode == 'zeros':
        out = out * valid.unsqueeze(1).to(x.dtype)
    return out


def resize_flow(flow: torch.Tensor, size_type: str, sizes: Sequence[float],
                interpolation: str = 'bilinear') -> torch.Tensor:
    """Resize a flow (N, H, W, 2) to a ratio or a shape and rescale its
    values to the new pixel size."""
    n, h, w, _ = flow.shape
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f'Size type should be ratio or shape, but got type {size_type}.')
    if interpolation not in ('bilinear', 'nearest'):
        raise ValueError(f'resize_flow: interpolation {interpolation!r} is not supported')
    maps = flow.permute(0, 3, 1, 2)
    if interpolation == 'bilinear':
        resized = F.interpolate(maps, size=(out_h, out_w), mode='bilinear', align_corners=False)
    else:
        resized = F.interpolate(maps, size=(out_h, out_w), mode='nearest')
    ratio = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype, device=flow.device)
    return resized.permute(0, 2, 3, 1) * ratio
