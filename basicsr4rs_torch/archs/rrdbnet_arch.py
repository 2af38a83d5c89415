"""RRDBNet, the ESRGAN and Real-ESRGAN generator (counterpart of
``basicsr4rs_tpu/archs/rrdbnet_arch.py``; reference:
basicsr/archs/rrdbnet_arch.py).

Residual-in-residual dense blocks (three 5-conv dense blocks, each residual
scaled by 0.2), a global residual, and two nearest x2 upsamplings each
followed by a conv: x4 of the input. Scales 2 and 1 first fold the input
into channels by ``pixel_unshuffle`` (x2, x4). BasicSR's key names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import default_init_weights, make_layer, pixel_unshuffle, resize_nearest


def lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    """Five convs, each seeing the input and every output before it; the
    last's output scaled by 0.2 on an identity skip. Every conv starts at a
    tenth of the Kaiming scale."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feat, num_grow_ch, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat + num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv3 = nn.Conv2d(num_feat + 2 * num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv4 = nn.Conv2d(num_feat + 3 * num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)
        default_init_weights([self.conv1, self.conv2, self.conv3, self.conv4, self.conv5], 0.1)

    def forward(self, x):
        x1 = lrelu(self.conv1(x))
        x2 = lrelu(self.conv2(torch.cat((x, x1), 1)))
        x3 = lrelu(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = lrelu(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Three dense blocks with a skip scaled by 0.2."""

    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):

    JAX_KEY_RULES = ()   # the generic rules of utils/jax_convert.py are all it needs

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32):
        super().__init__()
        # scales 2 and 1 fold the input by 2 and 4; any other takes it as it is
        self.unshuffle = {2: 2, 1: 4}.get(scale, 1)
        num_in_ch *= self.unshuffle**2
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(RRDB, num_block, num_feat=num_feat, num_grow_ch=num_grow_ch)
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W); returns (B, C_out, 4*H/u, 4*W/u), u the unshuffle."""
        if self.unshuffle > 1:
            x = pixel_unshuffle(x, self.unshuffle)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = lrelu(self.conv_up1(resize_nearest(feat, 2)))
        feat = lrelu(self.conv_up2(resize_nearest(feat, 2)))
        return self.conv_last(lrelu(self.conv_hr(feat)))
