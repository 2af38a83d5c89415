"""The align autoencoder, the LR encoder and the Swin UNet in one network
(counterpart of ``basicsr4rs_tpu/archs/alignae_unet_arch.py``; reference:
basicsr/archs/alignae_unet_arch.py), trained together by
``AlignJointDiffModel``, which calls the parts through the ``apply_*``
methods."""

from __future__ import annotations

from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .alignae_arch import AlignAutoencoder, LREncoder
from .unet_arch import UNetModelSwin


@ARCH_REGISTRY.register()
class ResNetAE_SwinUNet(nn.Module):
    """Keys ``unet.``, ``align_autoencoder.`` and ``lr_encoder.``. The
    forward is the UNet's."""

    JAX_KEY_RULES = UNetModelSwin.JAX_KEY_RULES   # they hold under the ``unet.`` prefix too

    def __init__(self, unet_args: dict, align_autoencoder_args: dict, lr_encoder_args: dict):
        super().__init__()
        self.unet = UNetModelSwin(**unet_args)
        self.align_autoencoder = AlignAutoencoder(**align_autoencoder_args)
        self.lr_encoder = LREncoder(**lr_encoder_args)

    def apply_unet(self, x, t, lq=None):
        return self.unet(x, t, lq=lq)

    def apply_ae_encode(self, x):
        return self.align_autoencoder.encode(x)

    def apply_ae_decode(self, z):
        return self.align_autoencoder.decode(z)

    def apply_lr_encode(self, x):
        return self.lr_encoder.encode(x)

    def forward(self, x, t, lq=None):
        return self.unet(x, t, lq=lq)
