"""GAN losses (counterpart of ``basicsr4rs_tpu/losses/gan_loss.py``;
reference: basicsr/losses/gan_loss.py).

``GANLoss`` (vanilla, lsgan, wgan, wgan_softplus, hinge),
``MultiScaleGANLoss``, and the regularisers ``r1_penalty``,
``g_path_regularize`` and ``gradient_penalty_loss``: each takes the
gradient of a network's output with respect to its input by
``torch.autograd.grad(..., create_graph=True)``, so that the penalty's own
gradient reaches the network's parameters. Their means are the global
batch's on several ranks (``dist_util.global_mean``: sums and counts, with
the gradient), as ``jnp.mean`` over the JAX mesh's sharded batch; a mean
of the ranks' means would be another function where the rows split
unevenly.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dist_util import global_mean
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


def _input_gradient(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """d sum(fn(x)) / dx, kept in the graph. ``x`` may be a tensor of the
    graph (its own gradient then flows too) or a plain one."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    grad, = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
    return grad


def r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
               real_img: torch.Tensor) -> torch.Tensor:
    """R1: the mean over the batch of |d D(x) / dx|^2 on the real images."""
    return global_mean(_input_gradient(d_fn, real_img).pow(2).sum(dim=(1, 2, 3)))


def g_path_regularize(fake_fn: Callable[[torch.Tensor], torch.Tensor], latents: torch.Tensor,
                      mean_path_length, noise: torch.Tensor, decay: float = 0.01):
    """StyleGAN2's path-length penalty. ``fake_fn(latents)`` is the image
    (N, C, H, W); ``noise`` (its shape) is divided by sqrt(H * W) and
    projects the image before the gradient with respect to the latents
    (N, L, F) is taken. Returns the penalty, the detached path lengths (N,)
    and the new running mean. A rank whose share of the path batch is empty
    (N = 0) runs no image and still takes part in the global means."""

    def proj(w):
        img = fake_fn(w)
        return img * (noise.to(img) / math.sqrt(img.shape[2] * img.shape[3]))

    if latents.shape[0]:
        grad = _input_gradient(proj, latents)
        path_lengths = torch.sqrt(grad.pow(2).sum(dim=2).mean(dim=1) + 1e-12)
    else:
        path_lengths = latents.new_zeros(0, requires_grad=True)
    # the running mean moves with this batch's lengths inside the penalty's graph
    path_mean = mean_path_length + decay * (global_mean(path_lengths) - mean_path_length)
    path_penalty = global_mean((path_lengths - path_mean).pow(2))
    return path_penalty, path_lengths.detach(), path_mean.detach()


def gradient_penalty_loss(d_fn: Callable[[torch.Tensor], torch.Tensor], real_data: torch.Tensor,
                          fake_data: torch.Tensor, alpha: torch.Tensor,
                          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP on the images interpolated by ``alpha`` (N, 1, 1, 1). The
    gradient's norm is taken over the channel axis only, pixel by pixel, as
    the reference does (not over the whole sample)."""
    alpha = alpha.to(real_data)
    grad = _input_gradient(d_fn, alpha * real_data + (1. - alpha) * fake_data)
    if weight is not None:
        grad = grad * weight
    loss = global_mean((torch.sqrt(grad.pow(2).sum(dim=1) + 1e-12) - 1).pow(2))
    if weight is not None:
        loss = loss / global_mean(weight)
    return loss
