"""Loss helpers: the weighted-reduction decorator (counterpart of
``basicsr4rs_tpu/losses/loss_util.py``; reference: basicsr/losses/loss_util.py)."""

from __future__ import annotations

import functools

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    """none / mean / sum."""
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'reduction "{reduction}" is not supported. Supported: none, mean, sum.')


def weight_reduce_loss(loss, weight=None, reduction: str = 'mean'):
    """Apply an elementwise weight, then reduce. A weighted mean divides by
    the sum of the weight broadcast to the loss's shape, as the JAX package
    does."""
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction in ('sum', 'none'):
        return reduce_loss(loss, reduction)
    return loss.sum() / (weight.expand_as(loss).sum() + 1e-12)


def weighted_loss(loss_func):
    """Decorator adding ``(weight, reduction)`` to an elementwise loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', **kwargs):
        return weight_reduce_loss(loss_func(pred, target, **kwargs), weight, reduction)

    return wrapper
