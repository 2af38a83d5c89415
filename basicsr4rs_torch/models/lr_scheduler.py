"""Learning-rate schedulers (counterpart of
``basicsr4rs_tpu/models/lr_scheduler.py``; reference:
basicsr/models/lr_scheduler.py) as ``torch.optim.lr_scheduler`` classes.
``MultiStepLR`` is torch's own. The linear warm-up of the JAX package's
``with_linear_warmup`` is ``linear_warmup_lr``, which
``BaseModel.update_learning_rate`` applies after the scheduler's step."""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

from torch.optim.lr_scheduler import LRScheduler


class MultiStepRestartLR(LRScheduler):
    """Decay by ``gamma`` at each milestone; at a restart iteration, reset to
    the initial lr times the restart's weight."""

    def __init__(self, optimizer, milestones: Sequence[int], gamma: float = 0.1,
                 restarts: Sequence[int] = (0,), restart_weights: Sequence[float] = (1,),
                 last_epoch: int = -1):
        if len(restarts) != len(restart_weights):
            raise ValueError('restarts and their weights do not match.')
        self.milestones = Counter(milestones)
        self.gamma = gamma
        self.restarts = list(restarts)
        self.restart_weights = list(restart_weights)
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> List[float]:
        if self.last_epoch in self.restarts:
            weight = self.restart_weights[self.restarts.index(self.last_epoch)]
            return [group['initial_lr'] * weight for group in self.optimizer.param_groups]
        if self.last_epoch not in self.milestones:
            return [group['lr'] for group in self.optimizer.param_groups]
        return [group['lr'] * self.gamma**self.milestones[self.last_epoch]
                for group in self.optimizer.param_groups]


def get_position_from_periods(iteration: int, cumulative_period: Sequence[int]) -> int:
    """Index of the first period whose cumulative end is >= ``iteration``."""
    for i, period in enumerate(cumulative_period):
        if iteration <= period:
            return i
    raise ValueError(f'iteration {iteration} exceeds cumulative periods {cumulative_period}')


class CosineAnnealingRestartLR(LRScheduler):
    """Cosine annealing with restarts: inside period i, which starts at
    ``start_i``, ``lr = eta_min + (base_lr * w_i - eta_min) / 2 *
    (1 + cos(pi * (t - start_i) / period_i))``. ``eta_min`` is the first
    param group's; a group with a learning-rate multiplier gets it times the
    multiplier, so that the groups keep their ratio at every iteration, as
    the JAX package's scaled updates do."""

    def __init__(self, optimizer, periods: Sequence[int],
                 restart_weights: Sequence[float] = (1,), eta_min: float = 0,
                 last_epoch: int = -1):
        if len(periods) != len(restart_weights):
            raise ValueError('periods and restart_weights should have the same length.')
        self.periods = list(periods)
        self.restart_weights = list(restart_weights)
        self.eta_min = eta_min
        self.cumulative_period = [sum(self.periods[0:i + 1]) for i in range(len(self.periods))]
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> List[float]:
        idx = get_position_from_periods(self.last_epoch, self.cumulative_period)
        weight = self.restart_weights[idx]
        start = 0 if idx == 0 else self.cumulative_period[idx - 1]
        period = self.periods[idx]
        cosine = 0.5 * (1 + math.cos(math.pi * (self.last_epoch - start) / period))
        rates = []
        for base_lr in self.base_lrs:
            eta_min = self.eta_min * base_lr / self.base_lrs[0]
            rates.append(eta_min + (base_lr * weight - eta_min) * cosine)
        return rates


def linear_warmup_lr(init_lrs: Sequence[float], current_iter: int,
                     warmup_iter: int) -> List[float]:
    """The warm-up learning rates of iteration ``current_iter`` (counted
    from 1) while ``current_iter < warmup_iter``: the initial rates, not the
    scheduled ones, scaled by ``current_iter / warmup_iter``."""
    return [lr / warmup_iter * current_iter for lr in init_lrs]
