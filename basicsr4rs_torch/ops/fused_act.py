"""Bias add and leaky ReLU scaled by sqrt(2) (counterpart of
``basicsr4rs_tpu/ops/fused_act.py``; reference:
basicsr/ops/fused_act/fused_act.py).

The reference fuses this into a CUDA kernel of its own; the JAX package
keeps it as three elementwise XLA ops, with no Pallas kernel, and so does
the port: plain PyTorch, which the card runs as elementwise kernels. The
bias is added along the channel axis, axis 1 (NCHW maps and (N, C)
vectors alike).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2**0.5) -> torch.Tensor:
    if bias is not None:
        x = x + bias.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
    return F.leaky_relu(x, negative_slope) * scale


class FusedLeakyReLU(nn.Module):
    """``fused_leaky_relu`` with a learnt bias (zeros at first)."""

    def __init__(self, num_channels: int, negative_slope: float = 0.2, scale: float = 2**0.5):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope) * math.sqrt(2)
