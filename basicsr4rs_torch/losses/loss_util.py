"""Loss helpers: the weighted-reduction decorator and LDL's artifact map
(counterpart of ``basicsr4rs_tpu/losses/loss_util.py``; reference:
basicsr/losses/loss_util.py)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


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


def get_refined_artifact_map(img_gt: torch.Tensor, img_output: torch.Tensor,
                             img_ema: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """LDL's locally discriminative artifact map (reference: loss_util.py
    ``get_refined_artifact_map``) of NCHW images: the unbiased variance of
    the output's channel-summed |residual| in each reflect-padded ``ksize``
    window, times the residual's unbiased variance over the whole image to
    the power 1/5; zero where the output already beats the EMA output."""
    pad = (ksize - 1) // 2
    n = ksize * ksize
    residual_ema = (img_gt - img_ema).abs().sum(dim=1, keepdim=True)
    residual_sr = (img_gt - img_output).abs().sum(dim=1, keepdim=True)
    patch_level_weight = residual_sr.var(dim=(1, 2, 3), keepdim=True)**(1 / 5)
    rp = F.pad(residual_sr, (pad, pad, pad, pad), mode='reflect')
    ones = torch.ones(1, 1, ksize, ksize, dtype=rp.dtype, device=rp.device)
    s1 = F.conv2d(rp, ones)
    s2 = F.conv2d(rp**2, ones)
    pixel_level_weight = (s2 - s1**2 / n) / (n - 1)
    overall_weight = patch_level_weight * pixel_level_weight
    return torch.where(residual_sr < residual_ema, torch.zeros_like(overall_weight),
                       overall_weight)
