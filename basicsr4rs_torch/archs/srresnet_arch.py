"""MSRResNet, the modified SRResNet baseline (counterpart of
``basicsr4rs_tpu/archs/srresnet_arch.py``; reference:
basicsr/archs/srresnet_arch.py:9-100).

x2/x3/x4 SISR: a first conv, ``num_block`` residual blocks without
normalisation, pixel-shuffle upsampling (two x2 stages for x4), two HR convs,
and a bilinearly upsampled copy of the input as the skip. BasicSR's module
tree and key names; every conv starts at a tenth of the Kaiming scale.
Under a spatial scope (``parallel/halo.py``) it runs on a band of rows: each
convolution takes its halo rows (``halo_conv``) and the skip one LQ row of
each neighbouring band (``resize_bilinear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import (ResidualBlockNoBN, default_init_weights, halo_conv, make_layer,
                        resize_bilinear)


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):

    # the generic rules of utils/jax_convert.py (body_3 -> body.3) are all it needs
    JAX_KEY_RULES = ()
    # runs on bands of rows under parallel.spatial > 1
    SPATIAL_SHARDING = True

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, upscale: int = 4):
        super().__init__()
        if upscale not in (2, 3, 4):
            raise ValueError(f'Unsupported upscale {upscale}; supported: 2, 3, 4.')
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block, num_feat=num_feat)
        if upscale == 4:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            self.upconv2 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            ups = [self.upconv1, self.upconv2]
        else:
            self.upconv1 = nn.Conv2d(num_feat, num_feat * upscale * upscale, 3, 1, 1)
            ups = [self.upconv1]
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        default_init_weights([self.conv_first, *ups, self.conv_hr, self.conv_last], 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W); returns (B, C_out, upscale*H, upscale*W)."""
        feat = F.leaky_relu(halo_conv(self.conv_first, x), 0.1)
        out = self.body(feat)
        shuffle = 2 if self.upscale == 4 else self.upscale
        out = F.leaky_relu(F.pixel_shuffle(halo_conv(self.upconv1, out), shuffle), 0.1)
        if self.upscale == 4:
            out = F.leaky_relu(F.pixel_shuffle(halo_conv(self.upconv2, out), 2), 0.1)
        out = halo_conv(self.conv_last, F.leaky_relu(halo_conv(self.conv_hr, out), 0.1))
        h, w = x.shape[-2:]
        return out + resize_bilinear(x, h * self.upscale, w * self.upscale)
