"""The align autoencoder for misregistered Landsat -> Sentinel pairs
(counterpart of ``basicsr4rs_tpu/archs/alignae_arch.py``; reference:
basicsr/archs/alignae_arch.py).

``AlignNet``: a 3x3 conv, ``num_block`` channel-attention blocks, and a 1x1
conv with padding 1, the reference's quirk, which grows the map by 2 each
way: an ``AlignNet`` of an (H, W) map answers (H + 2, W + 2)."""

from __future__ import annotations

from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import CAB


class AlignNet(nn.Module):

    def __init__(self, num_in_ch: int, num_out_ch: int, num_feat: int = 64, num_block: int = 4):
        super().__init__()
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[CAB(num_feat) for _ in range(num_block)])
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 1, 1, 1)

    def forward(self, x):
        return self.conv_last(self.body(self.conv_first(x)))


@ARCH_REGISTRY.register()
class LREncoder(nn.Module):
    """An ``AlignNet`` (key ``lr_encoder``) that maps the upsampled LQ into
    the align autoencoder's latent space."""

    def __init__(self, num_in_ch: int, num_out_ch: int, num_feat: int = 64, num_block: int = 8):
        super().__init__()
        self.lr_encoder = AlignNet(num_in_ch, num_out_ch, num_feat, num_block)

    def encode(self, x):
        return self.lr_encoder(x)

    def forward(self, x):
        return self.encode(x)


@ARCH_REGISTRY.register()
class AlignAutoencoder(nn.Module):
    """Two ``AlignNet``s: ``align_encoder`` takes the registration input
    (the upsampled LQ beside the GT, ``num_in_ch`` bands) to the latent
    (stage 1), ``decoder`` takes the latent to the image (stage 2). The
    forward returns ``{'stage1': ..., 'stage2': ...}``."""

    def __init__(self, num_in_ch: int, num_out_ch: int, num_feat: int = 64, num_block: int = 8):
        super().__init__()
        self.align_encoder = AlignNet(num_in_ch, num_out_ch, num_feat, num_block)
        self.decoder = AlignNet(num_out_ch, num_out_ch, num_feat, num_block)

    def encode(self, x):
        return self.align_encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        stage1 = self.encode(x)
        return {'stage1': stage1, 'stage2': self.decode(stage1)}


# the published AlignAutoencoder and StyleCNN configs name this network by
# its earlier name
ARCH_REGISTRY.register(AlignAutoencoder, 'StyleResNet')
