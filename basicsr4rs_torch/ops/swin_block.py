"""The whole Swin transformer block in one CUDA kernel, and its plain twin.

Counterpart of ``basicsr4rs_tpu/ops/swin_block.py``. ``fused_swin_block_full``
computes, for x (B, H, W, C) already rolled by the caller,

    y   = x + proj(W-MSA(LN1(x)))        # relative-position bias + shift mask
    out = y + fc2(GELU(fc1(LN2(y))))

A CUDA tensor goes to the hand-written kernel in
``csrc/swin_block_joint_fwd.cu``; a CPU tensor goes to
``reference_swin_block_full``, the plain PyTorch version. Weights are in the
``nn.Linear`` (out, in) layout and are cast to x's dtype; LayerNorm
parameters and biases are used in float32. The attention bias comes as the
relative-position bias (heads, n, n) and the shift mask (nW, n, n) or None,
so that nothing passed in grows with the image. Only the forward is
ported: the kernel has no backward yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from .mlp_block import layer_norm_f32, reference_mlp_block
from .window_attention import reference_window_attention

_KERNEL = 'swin_block_joint_fwd'
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS_PER_WINDOW = 64


def reference_swin_attn_block(x, ln_weight, ln_bias, qkv_weight, qkv_bias,
                              proj_weight, proj_bias, bias, window_size: int,
                              num_heads: int, scale: float):
    """proj(W-MSA(LN(x))) + proj_bias for x (B, H, W, C), same dtype as x.
    ``bias`` is the summed (nWb, heads, n, n) float32 attention bias."""
    dt = x.dtype
    xn = layer_norm_f32(x, ln_weight, ln_bias)
    qkv = (xn.to(dt) @ qkv_weight.to(dt).t()).float() + qkv_bias.float()
    a = reference_window_attention(qkv.to(dt), bias, window_size, num_heads, scale)
    z = (a @ proj_weight.to(dt).t()).float() + proj_bias.float()
    return z.to(dt)


def reference_swin_block_full(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                              proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                              ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                              window_size: int, num_heads: int, scale: float):
    """The plain PyTorch version of ``fused_swin_block_full``."""
    bias = rel_bias.float()[None]
    if mask is not None:
        bias = bias + mask.float()[:, None]
    y = x + reference_swin_attn_block(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                                      proj_weight, proj_bias, bias, window_size,
                                      num_heads, scale)
    return y + reference_mlp_block(y, ln2_weight, ln2_bias, fc1_weight, fc1_bias,
                                   fc2_weight, fc2_bias)


def fused_swin_block_full(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                          proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                          ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                          window_size: int, num_heads: int, scale: float):
    """The whole Swin block (attention + residual, MLP + residual) for x
    (B, H, W, C), already rolled; returns (B, H, W, C) in x's dtype.

    ``rel_bias``: (heads, n, n) relative-position bias with n = window_size**2;
    ``mask``: (nW, n, n) 0/-100 shift mask for the nW windows of one image,
    or None. Each launch of the kernel adds one to
    ``fused_swin_block_full.launches``."""
    args = (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
            rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, window_size, num_heads, scale)
    if x.device.type == 'cpu':
        return reference_swin_block_full(*args)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_swin_block_full: no kernel for device {x.device}')
    out = _launch(*args)
    fused_swin_block_full.launches += 1
    return out


fused_swin_block_full.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.swin_block_joint_fwd.argtypes = ([i, p, p] + [i] * 7 + [p] * 14
                                         + [ctypes.c_float, p])
    lib.swin_block_joint_fwd.restype = i
    lib.swin_block_joint_fwd_smem_bytes.argtypes = [i, i]
    lib.swin_block_joint_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.swin_block_joint_fwd_error.argtypes = [i]
    lib.swin_block_joint_fwd_error.restype = ctypes.c_char_p
    return lib


def _operand(t: torch.Tensor, name: str, shape, dtype, device) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, x on {device}')
    t = t.to(dtype)
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'{name} must be 16-byte aligned')
    return t


def _launch(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
            rel_bias, mask: Optional[torch.Tensor], ln2_weight, ln2_bias, fc1_weight,
            fc1_bias, fc2_weight, fc2_bias, window_size, num_heads, scale):
    if x.dtype not in _DTYPES:
        raise TypeError(f'fused_swin_block_full: x must be float32 or bfloat16, got {x.dtype}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError('fused_swin_block_full: x must be a contiguous (B, H, W, C) tensor')
    tensors = (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
               rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
               fc2_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError('fused_swin_block_full: the CUDA kernel has no '
                                  'backward yet; run under torch.no_grad()')
    b, h, w, c = x.shape
    hidden = fc1_weight.shape[0]
    n = window_size * window_size
    if h % window_size or w % window_size:
        raise ValueError(f'fused_swin_block_full: {h}x{w} is not a multiple of the '
                         f'window {window_size}')
    if n > MAX_TOKENS_PER_WINDOW:
        raise ValueError(f'fused_swin_block_full: window {window_size} has more than '
                         f'{MAX_TOKENS_PER_WINDOW} tokens')
    if c % num_heads or c % 4 or hidden % 4:
        raise ValueError(f'fused_swin_block_full: needs C % heads == 0, C % 4 == 0 and '
                         f'hidden % 4 == 0 (C={c}, heads={num_heads}, hidden={hidden})')
    lib = _lib()
    smem = lib.swin_block_joint_fwd_smem_bytes(c, num_heads)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f'fused_swin_block_full: C={c} needs {smem} bytes of shared '
                         f'memory per block, the device has {limit}')
    dev, f32 = x.device, torch.float32
    ops = [
        _operand(ln1_weight, 'ln1_weight', (c,), f32, dev),
        _operand(ln1_bias, 'ln1_bias', (c,), f32, dev),
        _operand(qkv_weight, 'qkv_weight', (3 * c, c), x.dtype, dev),
        _operand(qkv_bias, 'qkv_bias', (3 * c,), f32, dev),
        _operand(proj_weight, 'proj_weight', (c, c), x.dtype, dev),
        _operand(proj_bias, 'proj_bias', (c,), f32, dev),
        _operand(rel_bias, 'rel_bias', (num_heads, n, n), f32, dev),
        None if mask is None else _operand(
            mask, 'mask', ((h // window_size) * (w // window_size), n, n), f32, dev),
        _operand(ln2_weight, 'ln2_weight', (c,), f32, dev),
        _operand(ln2_bias, 'ln2_bias', (c,), f32, dev),
        _operand(fc1_weight, 'fc1_weight', (hidden, c), x.dtype, dev),
        _operand(fc1_bias, 'fc1_bias', (hidden,), f32, dev),
        _operand(fc2_weight, 'fc2_weight', (c, hidden), x.dtype, dev),
        _operand(fc2_bias, 'fc2_bias', (c,), f32, dev),
    ]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swin_block_joint_fwd(
            _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
            window_size, hidden, *[None if t is None else t.data_ptr() for t in ops],
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f'swin_block_joint_fwd launch failed: CUDA error {rc} '
                           f'({lib.swin_block_joint_fwd_error(rc).decode()})')
    return out
