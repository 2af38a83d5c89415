"""GAN losses (counterpart of ``basicsr4rs_tpu/losses/gan_loss.py``;
reference: basicsr/losses/gan_loss.py).

``GANLoss`` (vanilla, lsgan, wgan, wgan_softplus, hinge) and
``MultiScaleGANLoss``. The regularisers of that module (``r1_penalty``,
``g_path_regularize``, ``gradient_penalty_loss``) come with the StyleGAN2
model that calls them.
"""

from __future__ import annotations

from typing import List, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import LOSS_REGISTRY

GAN_TYPES = ('vanilla', 'lsgan', 'wgan', 'wgan_softplus', 'hinge')


@LOSS_REGISTRY.register()
class GANLoss(nn.Module):
    """The loss of a discriminator's prediction against the real or the
    fake label. ``loss_weight`` applies to the generator's terms only
    (``is_disc=False``), as in the reference. The vanilla loss is binary
    cross-entropy on the logits, ``max(p, 0) - p t + log1p(exp(-|p|))``."""

    def __init__(self, gan_type: str, real_label_val: float = 1.0, fake_label_val: float = 0.0,
                 loss_weight: float = 1.0):
        super().__init__()
        if gan_type not in GAN_TYPES:
            raise NotImplementedError(f'GAN type {gan_type} is not implemented.')
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _loss(self, pred: torch.Tensor, target_is_real: bool, is_disc: bool) -> torch.Tensor:
        if self.gan_type in ('vanilla', 'lsgan'):
            target = self.real_label_val if target_is_real else self.fake_label_val
            if self.gan_type == 'lsgan':
                return ((pred - target)**2).mean()
            return (pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()
        if self.gan_type == 'wgan':
            return -pred.mean() if target_is_real else pred.mean()
        if self.gan_type == 'wgan_softplus':
            return F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()
        if is_disc:   # hinge
            pred = -pred if target_is_real else pred
            return F.relu(1 + pred).mean()
        return -pred.mean()

    def forward(self, pred: torch.Tensor, target_is_real: bool,
                is_disc: bool = False) -> torch.Tensor:
        loss = self._loss(pred, target_is_real, is_disc)
        return loss if is_disc else loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """``GANLoss`` averaged over a list of predictions (a prediction that is
    itself a list counts by its last entry)."""

    def forward(self, pred: Union[List, torch.Tensor], target_is_real: bool,
                is_disc: bool = False) -> torch.Tensor:
        if not isinstance(pred, list):
            return super().forward(pred, target_is_real, is_disc)
        loss = 0.
        for pred_i in pred:
            if isinstance(pred_i, list):
                pred_i = pred_i[-1]
            loss = loss + super().forward(pred_i, target_is_real, is_disc)
        return loss / len(pred)
