"""HiFaceGANModel: face renovation with a conditional multiscale
discriminator (counterpart of ``basicsr4rs_tpu/models/hifacegan_model.py``;
reference: basicsr/models/hifacegan_model.py).

On the port's ``SRGANModel``: the discriminator sees the LQ input beside
the image (both resized to the output by the nearest rule), the fake and
the real pair in one batch that is split in half afterwards; the
generator's loss adds the feature-matching term (``feature_matching_opt``)
to the pixel, perceptual and GAN terms; the discriminator's loss is the
mean of its real and fake terms. EMA is refused, as in both packages.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..archs.hifacegan_util import nearest_resize_to
from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class HiFaceGANModel(SRGANModel):

    def init_training_settings(self):
        if self.opt['train'].get('ema_decay', 0) > 0:
            raise NotImplementedError('HiFaceGAN does not support EMA now. Pass')
        super().init_training_settings()
        train_opt = self.opt['train']
        self.cri_feat = (build_loss(train_opt['feature_matching_opt']).to(self.device)
                         if train_opt.get('feature_matching_opt') else None)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')

    def _discriminate(self, lq, output, gt):
        """(fake, real) predictions, a scale a list of stage outputs, from
        one pass of the fake and the real conditional pair together."""
        size = output.shape[2:]
        lq = nearest_resize_to(lq, size)
        gt = nearest_resize_to(gt, size)
        fake_and_real = torch.cat([torch.cat([lq, output], dim=1), torch.cat([lq, gt], dim=1)])
        half = output.shape[0]
        out = self.net_d(fake_and_real)
        return ([[t[:half] for t in scale] for scale in out],
                [[t[half:] for t in scale] for scale in out])

    def _g_losses(self, output):
        losses = OrderedDict()
        total = self.pixel_and_perceptual_losses(output, self.gt, losses,
                                                 ('l_g_pix', 'l_g_percep', 'l_g_style'))
        pred_fake, pred_real = self._discriminate(self.lq, output, self.gt)
        losses['l_g_gan'] = self.cri_gan(pred_fake, True, is_disc=False)
        total = total + losses['l_g_gan']
        if self.cri_feat is not None:
            losses['l_g_feat'] = self.cri_feat(pred_fake, pred_real)
            total = total + losses['l_g_feat']
        losses['l_g_total'] = total
        return total, losses

    def _d_losses(self, real, fake):
        pred_fake, pred_real = self._discriminate(self.lq, fake, real)
        l_d_real = self.cri_gan(pred_real, True, is_disc=True)
        l_d_fake = self.cri_gan(pred_fake, False, is_disc=True)
        return (l_d_real + l_d_fake) / 2, OrderedDict(l_d_real=l_d_real, l_d_fake=l_d_fake)
