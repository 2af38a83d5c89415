"""Pixel losses (counterpart of ``basicsr4rs_tpu/losses/basic_loss.py``;
reference: basicsr/losses/basic_loss.py). ``L1Loss``, ``MSELoss``,
``CharbonnierLoss``, ``WeightedTVLoss``, and ``GANFeatLoss``, the
feature-matching loss of a multiscale patch discriminator (HiFaceGAN's); the
rest come with the models that use them."""

from __future__ import annotations

import torch
from torch import nn

from ..utils.registry import LOSS_REGISTRY
from .loss_util import weighted_loss

_reduction_modes = ['none', 'mean', 'sum']


@weighted_loss
def l1_loss(pred, target):
    return (pred - target).abs()


@weighted_loss
def mse_loss(pred, target):
    return (pred - target)**2


@weighted_loss
def charbonnier_loss(pred, target, eps: float = 1e-12):
    return torch.sqrt((pred - target)**2 + eps)


class _PixelLoss(nn.Module):
    """``loss_weight`` times an elementwise loss, reduced."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = 'mean'):
        super().__init__()
        if reduction not in _reduction_modes:
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             f'Supported ones are: {_reduction_modes}')
        self.loss_weight = loss_weight
        self.reduction = reduction

    @property
    def SPATIAL_SHARDING(self) -> bool:   # noqa: N802  the flag the models read
        """Whether the loss runs on bands of rows (``parallel.spatial > 1``):
        an elementwise mean, whose mean over equal bands is the whole map's."""
        return self.reduction == 'mean'


@LOSS_REGISTRY.register()
class L1Loss(_PixelLoss):

    def forward(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * l1_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class MSELoss(_PixelLoss):

    def forward(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * mse_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss(_PixelLoss):
    """Differentiable variant of L1: sqrt(diff^2 + eps), eps 1e-12."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = 'mean', eps: float = 1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def forward(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * charbonnier_loss(pred, target, weight, eps=self.eps,
                                                   reduction=self.reduction)


@LOSS_REGISTRY.register()
class WeightedTVLoss(L1Loss):
    """Total variation as the L1 distance of each pixel to its neighbour
    below and to its right, each term with the matching part of ``weight``
    when one is given. NCHW; ``reduction`` 'mean' or 'sum'. No spatial
    route: the difference below a band's last row needs the next band's."""

    SPATIAL_SHARDING = False

    def __init__(self, loss_weight: float = 1.0, reduction: str = 'mean'):
        if reduction not in ('mean', 'sum'):
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             'Supported ones are: mean | sum')
        super().__init__(loss_weight=loss_weight, reduction=reduction)

    def forward(self, pred, weight=None, **kwargs):
        y_weight = None if weight is None else weight[:, :, :-1, :]
        x_weight = None if weight is None else weight[:, :, :, :-1]
        y_diff = super().forward(pred[:, :, :-1, :], pred[:, :, 1:, :], weight=y_weight)
        x_diff = super().forward(pred[:, :, :, :-1], pred[:, :, :, 1:], weight=x_weight)
        return x_diff + y_diff


@LOSS_REGISTRY.register()
class GANFeatLoss(nn.Module):
    """Feature matching: for each discriminator scale (a list of its
    stages' outputs), the ``criterion`` between the fake and the detached
    real output of every stage but the last, averaged over the scales."""

    def __init__(self, criterion: str = 'l1', loss_weight: float = 1.0, reduction: str = 'mean'):
        super().__init__()
        losses = {'l1': l1_loss, 'l2': mse_loss, 'mse': mse_loss, 'charbonnier': charbonnier_loss}
        if criterion not in losses:
            raise ValueError(f'Unsupported loss mode: {criterion}. '
                             'Supported ones are: l1|l2|charbonnier')
        self.loss_op = losses[criterion]
        self.loss_weight = loss_weight
        self.reduction = reduction

    def forward(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.
        for fake_feats, real_feats in zip(pred_fake, pred_real):
            for fake, real in zip(fake_feats[:-1], real_feats[:-1]):
                loss = loss + self.loss_op(fake, real.detach(), reduction=self.reduction) / num_d
        return loss * self.loss_weight
