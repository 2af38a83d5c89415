"""Registration-invariant losses for misaligned RS pairs (counterpart of
``basicsr4rs_tpu/losses/align_loss.py``; reference:
basicsr/losses/align_loss.py).

``RegisteredLoss`` takes the pixel loss of the prediction under every
Lanczos sub-pixel shift of a fixed bank and keeps each sample's least: the
loss no longer sees a small misregistration between LQ and GT. The bank is
built once, in numpy, as S separable kernels; a shift of the whole map is
two depthwise convolutions (S x S combinations)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..archs.arch_util import resize_bilinear
from ..utils.registry import LOSS_REGISTRY


def lanczos_kernel(dx: np.ndarray, a: int = 3) -> np.ndarray:
    """1-D Lanczos translation kernels: (S, 1) shifts in pixels -> (S, K)
    float32 kernels, K the same for all (the largest shift's support)."""
    dx = np.atleast_2d(np.asarray(dx, np.float64))
    D = np.ceil(np.abs(dx)).astype(int)
    S = 2 * (a + D) + 1
    N = S.max()
    Z = (N - S) // 2
    start = (-(a + D + Z)).min()
    end = (a + D + Z + 1).max()
    x = np.arange(start, end, dtype=np.float64)[None, :] - dx
    px = np.pi * x + 1e-3
    k = a * np.sin(px) * np.sin(px / a) / px**2
    return k.astype(np.float32)


class ShiftBank(nn.Module):
    """The shifts ``start``, ``start + step``, ... up to ``end`` (inclusive,
    within 1e-3), each a Lanczos-3 kernel."""

    def __init__(self, start: float, end: float, step: float):
        super().__init__()
        shifts = np.arange(start, end + 1e-3, step)[:, None]
        kernels = torch.from_numpy(lanczos_kernel(shifts, a=3))   # (S, K)
        self.num_shifts, self.ksize = kernels.shape
        self.register_buffer('kernels', kernels, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) -> (N, S*S, C, H, W): at index s * S + t, x shifted
        by the s-th kernel along H, then the t-th along W (cross-correlation,
        zero padding that keeps the size)."""
        n, c, h, w = x.shape
        s, k = self.num_shifts, self.ksize
        kernels = self.kernels.to(x.dtype)
        # depthwise: output channel c * S + s is channel c under shift s
        ys = F.conv2d(x, kernels.repeat(c, 1).view(c * s, 1, k, 1), padding=(k // 2, 0),
                      groups=c)
        out = F.conv2d(ys, kernels.repeat(c * s, 1).view(c * s * s, 1, 1, k),
                       padding=(0, k // 2), groups=c * s)
        return out.view(n, c, s * s, h, w).transpose(1, 2)


@LOSS_REGISTRY.register()
class RegisteredLoss(nn.Module):
    """The least over the bank's shifts of the mean elementwise loss
    (``l1``, or ``mse`` / ``l2``) per sample, away from a border of half the
    kernel, then reduced over the samples."""

    def __init__(self, start: float, end: float, step: float, loss_func: str = 'l1',
                 loss_weight: float = 1.0, reduction: str = 'mean'):
        super().__init__()
        if loss_func.lower() not in ('l1', 'mse', 'l2'):
            raise ValueError(f"Unsupported loss_func: {loss_func}. Choose from ['l1', 'mse']")
        if reduction not in ('none', 'mean', 'sum'):
            raise NotImplementedError(f'Unsupported reduction {reduction}')
        self.bank = ShiftBank(start, end, step)
        self.squared = loss_func.lower() != 'l1'
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.border = self.bank.ksize // 2

    def forward(self, y_pred, y):
        b = self.border
        shifted = self.bank(y_pred)[..., b:-b, b:-b]   # (N, S^2, C, H', W')
        diff = shifted - y[:, None, :, b:-b, b:-b]
        loss = (diff**2 if self.squared else diff.abs()).mean(dim=(2, 3, 4))
        min_loss = loss.amin(dim=1)
        if self.reduction == 'mean':
            min_loss = min_loss.mean()
        elif self.reduction == 'sum':
            min_loss = min_loss.sum()
        return self.loss_weight * min_loss


@LOSS_REGISTRY.register()
class EncoderLoss(nn.Module):
    """Mean square of the encoder's output against the GT (``strategy:
    gt``) or against the LQ enlarged bilinearly to its size (``lq``)."""

    def __init__(self, loss_weight: float = 1.0, strategy: str = 'gt', reduction: str = 'mean'):
        super().__init__()
        if strategy not in ('gt', 'lq'):
            raise ValueError(f'Unsupported loss strategy {strategy}')
        if reduction not in ('none', 'mean', 'sum'):
            raise ValueError(f'Unsupported reduction mode: {reduction}')
        self.loss_weight = loss_weight
        self.strategy = strategy
        self.reduction = reduction

    def forward(self, z_start, gt, lq=None):
        if self.strategy == 'gt':
            target = gt
        elif lq is None:
            raise ValueError("EncoderLoss(strategy='lq') requires the lq argument")
        else:
            target = resize_bilinear(lq, z_start.shape[2], z_start.shape[3])
        loss = (z_start - target)**2
        if self.reduction == 'mean':
            loss = loss.mean()
        elif self.reduction == 'sum':
            loss = loss.sum()
        return self.loss_weight * loss
