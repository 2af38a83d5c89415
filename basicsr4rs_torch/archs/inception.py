"""InceptionV3 feature extractor for FID (counterpart of
``basicsr4rs_tpu/archs/inception.py``; reference: basicsr/archs/inception.py,
itself pytorch-fid's port of TensorFlow's inception-2015-12-05 network).

The FID variant, for inference only: the A, C and E blocks' average pools
leave the padding out of their counts (``count_include_pad=False``),
Mixed_7c pools by max, and every BatchNorm (eps 1e-3) uses its running
statistics. Modules carry pytorch-fid's names (``Conv2d_1a_3x3``,
``Mixed_5b.branch1x1.conv`` ...), so ``pt_inception-2015-12-05-*.pth``
loads into it as it is, less its classifier. NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY

# pytorch-fid's weights (not in the repository: FID needs them in a file)
FID_WEIGHTS_URL = ('https://github.com/mseitzer/pytorch-fid/releases/download/'
                   'fid_weights/pt_inception-2015-12-05-6726825d.pth')
LOCAL_FID_WEIGHTS = 'experiments/pretrained_models/pt_inception-2015-12-05-6726825d.pth'


def _avg_pool_nopad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalises by its running statistics in train mode too."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0., self.eps)


class BasicConv2d(nn.Module):
    """Convolution without bias, frozen BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):

    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionB(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):

    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionD(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: 'avg' (Mixed_7b, padding left out of the counts) or 'max'
    (Mixed_7c), the FID network's two variants."""

    def __init__(self, in_channels: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool_nopad(x) if self.pool == 'avg' else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


@ARCH_REGISTRY.register()
class InceptionV3(nn.Module):
    """The FID InceptionV3, returning the outputs of the ``output_blocks``
    asked for (0: 64 channels after the first max pool, 1: 192 after the
    second, 2: 768 after Mixed_6e, 3: the 2048 pooled to 1x1), in order.
    Input NCHW RGB in [0, 1] with ``normalize_input`` (scaled to [-1, 1]),
    else in [-1, 1]; ``resize_input`` resizes it to 299x299 bilinearly,
    without antialiasing."""

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.output_blocks = tuple(sorted(output_blocks))
        if not self.output_blocks or self.output_blocks[-1] > 3:
            raise ValueError(f'output_blocks must be among 0 to 3, got {output_blocks}')
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, 'avg')
        self.Mixed_7c = InceptionE(2048, 'max')

    def blocks(self):
        """The four blocks, each a list of the stages it runs."""
        return [
            [self.Conv2d_1a_3x3, self.Conv2d_2a_3x3, self.Conv2d_2b_3x3,
             lambda x: F.max_pool2d(x, 3, stride=2)],
            [self.Conv2d_3b_1x1, self.Conv2d_4a_3x3, lambda x: F.max_pool2d(x, 3, stride=2)],
            [self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
             self.Mixed_6c, self.Mixed_6d, self.Mixed_6e],
            [self.Mixed_7a, self.Mixed_7b, self.Mixed_7c, lambda x: x.mean((2, 3), keepdim=True)],
        ]

    def forward(self, x):
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode='bilinear', align_corners=False)
        if self.normalize_input:
            x = 2 * x - 1
        outputs = []
        for index, stages in enumerate(self.blocks()[:self.output_blocks[-1] + 1]):
            for stage in stages:
                x = stage(x)
            if index in self.output_blocks:
                outputs.append(x)
        return outputs
