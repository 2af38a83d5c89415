"""SRVGGNetCompact, Real-ESRGAN's compact VGG-style SR network (counterpart
of ``basicsr4rs_tpu/archs/srvgg_arch.py``; reference:
basicsr/archs/srvgg_arch.py).

A conv and an activation, ``num_conv`` more of each, a last conv to
``num_out_ch * upscale**2`` channels and a pixel shuffle, plus the input
upsampled by nearest neighbour. ``body`` is BasicSR's ``ModuleList``:
convs at the even indices, activations (PReLU's slopes among the keys) at
the odd ones.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import resize_nearest


def activation(act_type: str, num_feat: int) -> nn.Module:
    if act_type == 'relu':
        return nn.ReLU()
    if act_type == 'prelu':
        return nn.PReLU(num_parameters=num_feat)
    if act_type == 'leakyrelu':
        return nn.LeakyReLU(negative_slope=0.1)
    raise ValueError(f'unsupported act_type {act_type}')


@ARCH_REGISTRY.register()
@ARCH_REGISTRY.register(name='SRVGGNetCompact_basicsr4rs_tpu')
class SRVGGNetCompact(nn.Module):

    JAX_KEY_RULES = ()   # the JAX PReLU's slope is its 'kernel': body_1.kernel -> body.1.weight

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 16, upscale: int = 4, act_type: str = 'prelu'):
        super().__init__()
        self.upscale = upscale
        self.body = nn.ModuleList([nn.Conv2d(num_in_ch, num_feat, 3, 1, 1),
                                   activation(act_type, num_feat)])
        for _ in range(num_conv):
            self.body.extend([nn.Conv2d(num_feat, num_feat, 3, 1, 1),
                              activation(act_type, num_feat)])
        self.body.append(nn.Conv2d(num_feat, num_out_ch * upscale * upscale, 3, 1, 1))
        self.upsampler = nn.PixelShuffle(upscale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for layer in self.body:
            out = layer(out)
        return self.upsampler(out) + resize_nearest(x, self.upscale)
