"""SRCNN, the three-layer classic in the RS fork's configurable form
(counterpart of ``basicsr4rs_tpu/archs/srcnn_arch.py``; reference:
basicsr/archs/srcnn_arch.py). The input is first enlarged bicubically
(a = -0.75, ``align_corners=True``)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import resize_bicubic


@ARCH_REGISTRY.register()
class SRCNN(nn.Module):

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.conv1 = nn.Conv2d(num_in_ch, 64, 9, padding=4)
        self.conv2 = nn.Conv2d(64, 32, 5, padding=2)
        self.conv3 = nn.Conv2d(32, num_out_ch, 5, padding=2)

    def forward(self, x):
        x = resize_bicubic(x, self.upscale, align_corners=True)
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
