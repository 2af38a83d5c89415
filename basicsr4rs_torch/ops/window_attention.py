"""Windowed multi-head attention, plain PyTorch.

Counterpart of ``basicsr4rs_tpu/ops/window_attention.py``. Only the plain
reference is ported so far; the fused attention kernel and its backward
(used by the diffusion UNet) come later.
"""

from __future__ import annotations

import torch


def reference_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                               window_size: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """Windowed MHA from packed q|k|v.

    Args:
      qkv: (B, H, W, 3C).
      bias: (nWb, heads, n, n) float32: relative-position bias (+ shift
        mask); nWb is 1 (broadcast over windows) or the windows per image.
      window_size, num_heads, scale: attention geometry.
    Returns: (B, H, W, C) in the dtype of ``qkv``.
    """
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ws, n = window_size, window_size * window_size
    hd = c // num_heads
    nwh, nww = h // ws, w // ws

    x = qkv.reshape(b, nwh, ws, nww, ws, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = x.reshape(-1, n, 3, num_heads, hd).unbind(2)
    attn = torch.einsum('nqhc,nkhc->nhqk', (q * scale).float(), k.float())
    nwb = bias.shape[0]
    attn = attn.reshape(-1, nwb, num_heads, n, n) + bias[None]
    attn = torch.softmax(attn.reshape(-1, num_heads, n, n), dim=-1)
    out = torch.einsum('nhqk,nkhc->nqhc', attn.to(qkv.dtype), v)
    out = out.reshape(b, nwh, nww, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h, w, c)
