"""EDSR (counterpart of ``basicsr4rs_tpu/archs/edsr_arch.py``; reference:
basicsr/archs/edsr_arch.py).

Residual blocks scaled by ``res_scale`` (no normalisation), a global
residual, the pixel-shuffle upsampler of ``arch_util`` (whose convolutions
run through the 3x3 convolution kernel under ``SWIN_FUSED_CONV=1``), and
DIV2K's mean shift: the RGB mean times ``img_range`` comes off the input
and goes back on at the output. BasicSR's module tree and key names.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import ResidualBlockNoBN, Upsample, make_layer


@ARCH_REGISTRY.register()
class EDSR(nn.Module):

    JAX_KEY_RULES = Upsample.JAX_KEY_RULES

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 4, res_scale: float = 1.,
                 img_range: float = 255., rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.img_range = img_range
        self.register_buffer('mean', torch.tensor(rgb_mean, dtype=torch.float32).view(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block, num_feat=num_feat,
                               res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.mean.to(x.dtype)
        x = self.conv_first((x - mean) * self.img_range)
        res = self.conv_after_body(self.body(x)) + x
        return self.conv_last(self.upsample(res)) / self.img_range + mean
