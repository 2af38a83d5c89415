"""Adafactor and Lamb as ``torch.optim.Optimizer``s with the update rules of
``optax.adafactor`` and ``optax.lamb``, which the JAX package's
``build_optimizer`` uses (``torch.optim.Adafactor`` follows another rule).
The learning rate is the param group's ``lr``, which the port's schedulers
set, as for Adam.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second largest and the largest dimension of ``shape``,
    over which Adafactor factors the second moment, or None when the tensor
    has fewer than two dimensions or the second largest is under
    ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind='stable')
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with its defaults, the only ones the JAX
    package uses: the second moment factored over the two largest
    dimensions when both are at least ``MIN_DIM_SIZE_TO_FACTOR`` (a row and a
    column estimate), else kept whole, decayed by ``1 - (step + 1) **
    -DECAY_RATE``, the squared gradient offset by ``EPS``; the update's RMS
    clipped to ``CLIPPING_THRESHOLD``, then scaled by the rate and by the
    parameter's RMS (at least ``MIN_SCALE``); no momentum, no weight decay.
    The factored estimate is symmetric in its two dimensions, so the update
    does not depend on the layout (OIHW here, HWIO in the JAX package)."""

    DECAY_RATE = 0.8
    MIN_DIM_SIZE_TO_FACTOR = 128
    CLIPPING_THRESHOLD = 1.0
    MIN_SCALE = 1e-3
    EPS = 1e-30

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p], group['lr'])
        return loss

    def _update(self, p, grad, state, lr):
        dims = factored_dims(p.shape, self.MIN_DIM_SIZE_TO_FACTOR)
        if not state:
            state['step'] = 0
            if dims is None:
                state['v'] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state['v_row'] = torch.zeros_like(p.select(d0, 0))
                state['v_col'] = torch.zeros_like(p.select(d1, 0))
        decay = 1. - (state['step'] + 1) ** -self.DECAY_RATE
        state['step'] += 1
        grad_sq = grad * grad + self.EPS
        if dims is None:
            v = state['v'].mul_(decay).add_(grad_sq, alpha=1. - decay)
            update = grad * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = state['v_row'].mul_(decay).add_(grad_sq.mean(d0), alpha=1. - decay)
            v_col = state['v_col'].mul_(decay).add_(grad_sq.mean(d1), alpha=1. - decay)
            row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            update = (grad * (v_row / row_mean).rsqrt().unsqueeze(d0)
                      * v_col.rsqrt().unsqueeze(d1))
        clip = torch.clamp(update.square().mean().sqrt() / self.CLIPPING_THRESHOLD, min=1.)
        scale = p.square().mean().sqrt().clamp(min=self.MIN_SCALE)
        p.sub_(update / clip * lr * scale)


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: Adam's moments with bias correction, the update
    ``m_hat / (sqrt(v_hat) + eps)``, plus ``weight_decay`` times the
    parameter (decoupled), times the tensor's trust ratio
    ``||p|| / ||update||`` (1 where either norm is 0), times the rate.
    The defaults are the JAX package's (``eps`` 1e-8, no decay)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    state['exp_avg'] = torch.zeros_like(p)
                    state['exp_avg_sq'] = torch.zeros_like(p)
                state['step'] += 1
                t = state['step']
                m = state['exp_avg'].mul_(b1).add_(p.grad, alpha=1. - b1)
                v = state['exp_avg_sq'].mul_(b2).addcmul_(p.grad, p.grad, value=1. - b2)
                update = (m / (1. - b1**t)) / ((v / (1. - b2**t)).sqrt() + group['eps'])
                if group['weight_decay']:
                    update.add_(p, alpha=group['weight_decay'])
                p_norm, u_norm = p.norm(), update.norm()
                trust = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                p.sub_(update * trust * group['lr'])
        return loss
