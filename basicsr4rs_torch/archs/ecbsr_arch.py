"""ECBSR, edge-oriented convolution blocks for real-time SR (counterpart of
``basicsr4rs_tpu/archs/ecbsr_arch.py``; reference:
basicsr/archs/ecbsr_arch.py).

In training an ECB sums five branches: a 3x3 conv, a 1x1 expansion followed
by a 3x3 conv, and three 1x1 convs followed by fixed Sobel-x, Sobel-y and
Laplacian filters scaled per channel (each 1x1 output padded with its own
bias, so that the sum is one 3x3 conv exactly). In eval mode the block runs
that one conv: ``ecb_rep_params`` folds the five branches (and the identity,
``with_idt``) into a 3x3 weight and a bias, as the reference's deployment
does. BasicSR's parameter names (``k0``, ``b0``, ``k1``, ``b1``, ``scale``,
``bias``); the fixed masks are constants here, and a checkpoint's ``mask``
entries are read and dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY

def edge_mask(seq_type: str, channels: int) -> torch.Tensor:
    """The fixed 3x3 filter of an edge branch, one per channel: (C, 1, 3, 3)."""
    m = torch.zeros(3, 3)
    if seq_type == 'conv1x1-sobelx':
        m[:, 0] = torch.tensor([1., 2., 1.])
        m[:, 2] = torch.tensor([-1., -2., -1.])
    elif seq_type == 'conv1x1-sobely':
        m[0, :] = torch.tensor([1., 2., 1.])
        m[2, :] = torch.tensor([-1., -2., -1.])
    elif seq_type == 'conv1x1-laplacian':
        m[0, 1] = m[1, 0] = m[1, 2] = m[2, 1] = 1.
        m[1, 1] = -4.
    else:
        raise ValueError(f'the type of seqconv {seq_type} is not supported')
    return m.expand(channels, 1, 3, 3).clone()


def pad_with_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y`` padded by one pixel whose value is the bias of each channel
    (adding zero inside leaves ``y`` exact)."""
    h, w = y.shape[-2:]
    border = torch.ones(h + 2, w + 2, dtype=y.dtype, device=y.device)
    border[1:-1, 1:-1] = 0
    return F.pad(y, (1, 1, 1, 1)) + b.view(1, -1, 1, 1) * border


class SeqConv3x3(nn.Module):
    """A 1x1 conv followed by a 3x3 one: learnt (``conv1x1-conv3x3``, to
    ``out_channels * depth_multiplier`` channels in between) or a fixed edge
    filter scaled per channel (depthwise)."""

    def __init__(self, seq_type: str, in_channels: int, out_channels: int,
                 depth_multiplier: float = 1.):
        super().__init__()
        self.seq_type = seq_type
        self.out_channels = out_channels
        if seq_type == 'conv1x1-conv3x3':
            self.mid_planes = int(out_channels * depth_multiplier)
            conv0 = nn.Conv2d(in_channels, self.mid_planes, 1)
            conv1 = nn.Conv2d(self.mid_planes, out_channels, 3)
            self.k0, self.b0 = conv0.weight, conv0.bias
            self.k1, self.b1 = conv1.weight, conv1.bias
        else:
            conv0 = nn.Conv2d(in_channels, out_channels, 1)
            self.k0, self.b0 = conv0.weight, conv0.bias
            self.scale = nn.Parameter(torch.randn(out_channels, 1, 1, 1) * 1e-3)
            self.bias = nn.Parameter(torch.randn(out_channels) * 1e-3)
            self.register_buffer('mask', edge_mask(seq_type, out_channels), persistent=False)

    def forward(self, x):
        y0 = pad_with_bias(F.conv2d(x, self.k0, self.b0), self.b0)
        if self.seq_type == 'conv1x1-conv3x3':
            return F.conv2d(y0, self.k1, self.b1)
        return F.conv2d(y0, self.scale * self.mask, self.bias, groups=self.out_channels)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + 'mask', None)   # the reference keeps the fixed filter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def seqconv_rep_params(seq: SeqConv3x3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3x3 conv (weight (O, I, 3, 3), bias (O,)) a ``SeqConv3x3`` equals:
    the 1x1 conv folded into the 3x3 one, and the 3x3 conv of a patch of
    the 1x1 bias into the bias."""
    if seq.seq_type == 'conv1x1-conv3x3':
        k1, b1 = seq.k1, seq.b1
    else:   # the depthwise filter as a diagonal full kernel
        eye = torch.eye(seq.out_channels, device=seq.k0.device, dtype=seq.k0.dtype)
        k1 = (seq.scale * seq.mask)[:, 0, None] * eye[:, :, None, None]
        b1 = seq.bias
    weight = torch.einsum('omhw,mi->oihw', k1, seq.k0[:, :, 0, 0])
    bias = torch.einsum('m,omhw->o', seq.b0, k1) + b1
    return weight, bias


class ECB(nn.Module):
    """Edge-oriented convolution block: five branches (one conv in eval
    mode), the identity where ``with_idt`` and the widths agree, then the
    activation."""

    BRANCHES = (('conv1x1_3x3', 'conv1x1-conv3x3'), ('conv1x1_sbx', 'conv1x1-sobelx'),
                ('conv1x1_sby', 'conv1x1-sobely'), ('conv1x1_lpl', 'conv1x1-laplacian'))

    def __init__(self, in_channels: int, out_channels: int, depth_multiplier: float,
                 act_type: str = 'prelu', with_idt: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.act_type = act_type
        self.with_idt = with_idt and in_channels == out_channels
        self.conv3x3 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        for name, seq_type in self.BRANCHES:
            setattr(self, name, SeqConv3x3(seq_type, in_channels, out_channels,
                                           depth_multiplier if seq_type == 'conv1x1-conv3x3'
                                           else 1.))
        if act_type == 'prelu':
            self.act = nn.PReLU(num_parameters=out_channels)
        elif act_type == 'relu':
            self.act = nn.ReLU()
        elif act_type == 'softplus':
            self.act = nn.Softplus()
        elif act_type != 'linear':
            raise ValueError(f'activation {act_type} not supported')

    def forward(self, x):
        if self.training:
            y = self.conv3x3(x)
            for name, _ in self.BRANCHES:
                y = y + getattr(self, name)(x)
            if self.with_idt:
                y = y + x
        else:
            weight, bias = ecb_rep_params(self)
            y = F.conv2d(x, weight, bias, padding=1)
        return y if self.act_type == 'linear' else self.act(y)


def ecb_rep_params(ecb: ECB) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3x3 conv (weight (O, I, 3, 3), bias (O,)) an ``ECB``'s branches,
    and its identity where it has one, sum to."""
    weight, bias = ecb.conv3x3.weight, ecb.conv3x3.bias
    for name, _ in ecb.BRANCHES:
        w, b = seqconv_rep_params(getattr(ecb, name))
        weight, bias = weight + w, bias + b
    if ecb.with_idt:
        idt = torch.zeros_like(weight)
        idt[:, :, 1, 1] = torch.eye(ecb.out_channels, device=weight.device, dtype=weight.dtype)
        weight = weight + idt
    return weight, bias


@ARCH_REGISTRY.register()
class ECBSR(nn.Module):

    # the JAX edge branches' per-channel factor is named scale, which the
    # generic rules read as a norm's weight
    JAX_KEY_RULES = ((r'(conv1x1_(?:sbx|sby|lpl))\.weight$', r'\1.scale'),)

    def __init__(self, num_in_ch: int = 1, num_out_ch: int = 1, num_block: int = 4,
                 num_channel: int = 16, with_idt: bool = False, act_type: str = 'prelu',
                 scale: int = 4):
        super().__init__()
        self.num_in_ch = num_in_ch
        self.scale = scale
        backbone = [ECB(num_in_ch, num_channel, 2.0, act_type, with_idt)]
        backbone += [ECB(num_channel, num_channel, 2.0, act_type, with_idt)
                     for _ in range(num_block)]
        backbone += [ECB(num_channel, num_out_ch * scale * scale, 2.0, 'linear', with_idt)]
        self.backbone = nn.Sequential(*backbone)
        self.upsampler = nn.PixelShuffle(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = torch.repeat_interleave(x, self.scale * self.scale, dim=1)
        return self.upsampler(self.backbone(x) + shortcut)
