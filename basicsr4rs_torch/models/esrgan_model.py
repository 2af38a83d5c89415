"""ESRGANModel, the relativistic average GAN (counterpart of
``basicsr4rs_tpu/models/esrgan_model.py``; reference:
basicsr/models/esrgan_model.py).

``SRGANModel`` with each prediction judged against the mean of the other
side's: the generator's loss is the mean of the real batch's loss as fake
and the output's as real (the real predictions detached); the
discriminator's is half its loss on the real batch against the mean of a
detached pass over the output (a pass that keeps the BatchNorm statistics)
and half on the output against the mean of the real predictions, detached.
The generator sees the discriminator from before this step's update.
On several ranks each of those means is the global batch's
(``dist_util.global_mean``, with its gradient), as ``jnp.mean`` over the JAX
mesh's sharded batch.
"""

from __future__ import annotations

from collections import OrderedDict

from ..archs.arch_util import frozen_batch_stats
from ..utils.dist_util import global_mean
from ..utils.registry import MODEL_REGISTRY
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):

    def _g_gan_loss(self, output):
        real_d_pred = self.net_d(self.gt).detach()
        fake_g_pred = self.net_d(output)
        l_g_real = self.cri_gan(real_d_pred - global_mean(fake_g_pred), False, is_disc=False)
        l_g_fake = self.cri_gan(fake_g_pred - global_mean(real_d_pred), True, is_disc=False)
        return (l_g_real + l_g_fake) / 2

    def _d_losses(self, real, fake):
        with frozen_batch_stats(self.net_d):
            fake_d_pred_const = self.net_d(fake).detach()
        real_d_pred = self.net_d(real)
        l_d_real = self.cri_gan(real_d_pred - global_mean(fake_d_pred_const), True,
                                is_disc=True) * 0.5
        fake_d_pred = self.net_d(fake)
        l_d_fake = self.cri_gan(fake_d_pred - global_mean(real_d_pred.detach()), False,
                                is_disc=True) * 0.5
        losses = OrderedDict(l_d_real=l_d_real, l_d_fake=l_d_fake,
                             out_d_real=real_d_pred.detach().mean(),
                             out_d_fake=fake_d_pred.detach().mean())
        return l_d_real + l_d_fake, losses
