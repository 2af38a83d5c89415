"""Transformer MLP branch LN -> fc1 -> GELU -> fc2, plain PyTorch.

Counterpart of ``basicsr4rs_tpu/ops/mlp_block.py``. Only the plain reference
is ported so far; the fused MLP kernel and its backward (the training path)
come later.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim in float32 with var = E[x^2] - mean^2,
    as the JAX package computes it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * weight.float() + bias.float()


def reference_mlp_block(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                        fc2_bias):
    """fc2(gelu(fc1(LN(x)))) for x (..., C), same shape and dtype as x.
    Weights in the ``nn.Linear`` (out, in) layout; GEMMs run in x's dtype."""
    dt = x.dtype
    xn = layer_norm_f32(x, ln_weight, ln_bias)
    h = (xn.to(dt) @ fc1_weight.to(dt).t()).float() + fc1_bias.float()
    h = F.gelu(h)
    z = (h.to(dt) @ fc2_weight.to(dt).t()).float() + fc2_bias.float()
    return z.to(dt)
