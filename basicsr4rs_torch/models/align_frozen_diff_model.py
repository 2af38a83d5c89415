"""ResShift over the latents of a frozen align autoencoder (counterpart of
``basicsr4rs_tpu/models/align_frozen_diff_model.py``; reference:
basicsr/models/align_frozen_diff_model.py).

As ``ResShiftL2SModel``, with ``autoencoder`` an ``AlignAutoencoder`` and
the align diffusion engine: the GT's latent is the encoding of the
registration input (the LQ x3 beside the GT), the LQ's that of the LQ x3
beside itself, both cropped about the centre to the UNet's ``image_size``;
``test()`` samples, decodes and crops to the GT."""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from ..utils.gaussian_diffusion_align import create_gaussian_diffusion_align
from ..utils.registry import MODEL_REGISTRY
from .align_single_model import center_crop_to, registration_input
from .resshift_l2s_model import ResShiftL2SModel


class AlignFirstStage:
    """A frozen ``AlignAutoencoder`` as the engine's first stage. Its
    encoder takes twice the bands of an image: an image alone (the LQ side,
    when sampling or conditioning) fills the GT's slot with itself, as the
    jointly trained model fills it with its LR encoder. The encoding is
    cropped about its centre to ``latent_size`` where it is larger (each
    ``AlignNet`` grows the map by 2)."""

    def __init__(self, net, latent_size: Optional[int] = None):
        self.net = net
        self.in_ch = net.align_encoder.conv_first.in_channels
        self.latent_size = latent_size

    def encode(self, x):
        if x.shape[1] * 2 == self.in_ch:
            x = torch.cat([x, x], dim=1)
        out = self.net.encode(x)
        if self.latent_size is not None and out.shape[-2] > self.latent_size:
            out = center_crop_to(out, self.latent_size, self.latent_size)
        return out

    def decode(self, z):
        return self.net.decode(z)


@MODEL_REGISTRY.register()
class AlignFrozenDiffModel(ResShiftL2SModel):

    def __init__(self, opt):
        super().__init__(opt)
        if self.first_stage is not None:
            self.first_stage = AlignFirstStage(self.first_stage,
                                               self.opt['network_g'].get('image_size'))
        self.base_diffusion = create_gaussian_diffusion_align(**self.opt['diffusion'])

    def feed_data(self, data):
        super().feed_data(data)
        if 'gt' in data:
            self.reg_input = registration_input(self.lq, self.gt)

    def _timesteps(self):
        """The fed timesteps, else one drawn per sample from the generator."""
        if self.tt is not None:
            return self.tt
        return torch.randint(0, self.base_diffusion.num_timesteps, (self.gt.shape[0],),
                             generator=self.generator,
                             device=self.generator.device).to(self.device)

    def compute_losses(self):
        loss_dict, _, _ = self.base_diffusion.training_losses(
            self.generator, self._denoiser(self.net_g), self.reg_input, self.lq,
            self._timesteps(), first_stage_model=self.first_stage, noise=self.noise)
        loss = loss_dict['mse'].mean()
        return loss, OrderedDict(loss=loss, mse=loss)

    def test(self):
        super().test()
        if hasattr(self, 'gt'):
            self.output = center_crop_to(self.output, *self.gt.shape[-2:])
