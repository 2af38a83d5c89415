"""The Swin transformer block as CUDA kernels, and their plain twins.

Counterpart of ``basicsr4rs_tpu/ops/swin_block.py``. For x (B, H, W, C)
already rolled by the caller:

- ``fused_swin_block_full`` (inference) computes the whole block,

      y   = x + proj(W-MSA(LN1(x)))        # relative-position bias + shift mask
      out = y + fc2(GELU(fc1(LN2(y))))

  in one launch of ``csrc/swin_block_joint_fwd.cu``; it has no backward.
- ``fused_swin_attn_block`` (training) is the attention branch
  ``proj(W-MSA(LN(x)))`` as a ``torch.autograd.Function`` over
  ``swin_attn_block_forward`` (``csrc/swin_attn_block_fwd.cu``) and
  ``swin_attn_block_backward`` (``csrc/swin_attn_block_bwd.cu``), with the
  output modes of ``ops.mlp_block``: the branch alone, ``+ x``, or
  ``s[b] * branch + x``.

Every wrapper sends a CUDA tensor to its kernel and a CPU tensor to its
plain PyTorch version (``reference_*``), and counts its launches in
``.launches``. Weights are in the ``nn.Linear`` (out, in) layout and are cast
to x's dtype; LayerNorm parameters and biases are used in float32. The
attention bias comes as the relative-position bias (heads, n, n) and the
shift mask (nW, n, n) or None, so that nothing passed in grows with the
image.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _launch
from .mlp_block import fold_branch, layer_norm_f32, reference_mlp_block
from .window_attention import reference_window_attention

MAX_TOKENS_PER_WINDOW = 64


def _attention_bias(rel_bias, mask):
    """(1 | nW, heads, n, n) float32 sum of relative-position bias and mask."""
    bias = rel_bias.float()[None]
    return bias if mask is None else bias + mask.float()[:, None]


def reference_swin_attn_block(x, ln_weight, ln_bias, qkv_weight, qkv_bias,
                              proj_weight, proj_bias, rel_bias, mask, window_size: int,
                              num_heads: int, scale: float, add_residual: bool = False,
                              residual_scale=None):
    """The plain PyTorch version of ``swin_attn_block_forward``:
    proj(W-MSA(LN(x))) + proj_bias for x (B, H, W, C), same dtype as x."""
    dt = x.dtype
    xn = layer_norm_f32(x, ln_weight, ln_bias)
    qkv = (xn.to(dt) @ qkv_weight.to(dt).t()).float() + qkv_bias.float()
    a = reference_window_attention(qkv.to(dt), _attention_bias(rel_bias, mask), window_size,
                                   num_heads, scale)
    z = (a @ proj_weight.to(dt).t()).float() + proj_bias.float()
    return fold_branch(x, z, add_residual, residual_scale)


def reference_swin_attn_block_backward(x, dz, ln_weight, ln_bias, qkv_weight, qkv_bias,
                                       proj_weight, rel_bias, mask, window_size: int,
                                       num_heads: int, scale: float,
                                       add_residual: bool = False, residual_scale=None):
    """The plain PyTorch version of ``swin_attn_block_backward``: the same
    tuple, by autograd through ``reference_swin_attn_block``."""
    f32 = torch.float32
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_()] + [
            t.detach().to(f32).requires_grad_()
            for t in (ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight)]
        proj_bias = torch.zeros(x.shape[-1], dtype=f32, device=x.device, requires_grad=True)
        rel = rel_bias.detach().to(f32).requires_grad_()
        out = reference_swin_attn_block(*leaves, proj_bias, rel, mask, window_size, num_heads,
                                        scale, add_residual, residual_scale)
        return torch.autograd.grad(out, leaves + [proj_bias, rel], dz)


def swin_attn_block_forward(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                            proj_bias, rel_bias, mask, window_size: int, num_heads: int,
                            scale: float, add_residual: bool = False, residual_scale=None):
    """The attention branch of x (B, H, W, C) in one kernel launch; no autograd."""
    args = (x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias,
            mask, window_size, num_heads, scale, add_residual, residual_scale)
    if x.device.type == 'cpu':
        return reference_swin_attn_block(*args)
    if x.device.type != 'cuda':
        raise ValueError(f'swin_attn_block_forward: no kernel for device {x.device}')
    out = _launch_attn_forward(*args)
    swin_attn_block_forward.launches += 1
    return out


swin_attn_block_forward.launches = 0


def swin_attn_block_backward(x, dz, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                             rel_bias, mask, window_size: int, num_heads: int, scale: float,
                             add_residual: bool = False, residual_scale=None):
    """(dx, d ln_weight, d ln_bias, d qkv_weight, d qkv_bias, d proj_weight,
    d proj_bias, d rel_bias) of the attention branch in one kernel launch,
    from x and the cotangent dz of the output; dx in x's dtype, the rest
    float32. d rel_bias (heads, n, n) sums over every window and sample; the
    mask gets no gradient."""
    args = (x, dz, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, rel_bias, mask,
            window_size, num_heads, scale, add_residual, residual_scale)
    if x.device.type == 'cpu':
        return reference_swin_attn_block_backward(*args)
    if x.device.type != 'cuda':
        raise ValueError(f'swin_attn_block_backward: no kernel for device {x.device}')
    grads = _launch_attn_backward(*args)
    swin_attn_block_backward.launches += 1
    return grads


swin_attn_block_backward.launches = 0


class _FusedSwinAttnBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                rel_bias, mask, window_size, num_heads, scale, add_residual, residual_scale):
        ctx.save_for_backward(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                              proj_bias, rel_bias, mask, residual_scale)
        ctx.geometry = (window_size, num_heads, scale, add_residual)
        return swin_attn_block_forward(x, ln_weight, ln_bias, qkv_weight, qkv_bias,
                                       proj_weight, proj_bias, rel_bias, mask, window_size,
                                       num_heads, scale, add_residual, residual_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        *params, proj_bias, rel_bias, mask, residual_scale = ctx.saved_tensors
        x = params[0]
        grads = swin_attn_block_backward(x, dz.to(x.dtype).contiguous(), *params[1:], rel_bias,
                                         mask, *ctx.geometry, residual_scale)
        like = (*params, proj_bias, rel_bias)
        return (*(g.to(p.dtype) for g, p in zip(grads, like)), None, None, None, None, None,
                None)


def fused_swin_attn_block(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                          rel_bias, mask, window_size: int, num_heads: int, scale: float,
                          add_residual: bool = False, residual_scale=None):
    """proj(W-MSA(LN(x))) for x (B, H, W, C) already rolled, differentiable;
    forward and backward are one kernel launch each on a CUDA tensor.

    ``rel_bias``: (heads, n, n) relative-position bias with n = window_size**2;
    ``mask``: (nW, n, n) 0/-100 shift mask for the nW windows of one image,
    or None (no gradient). ``add_residual`` returns ``x + branch``;
    ``residual_scale`` (B,) float32, DropPath's mask / keep per sample,
    returns ``x + s[b] * branch`` and gets no gradient."""
    return _FusedSwinAttnBlock.apply(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                                     proj_bias, rel_bias, mask, window_size, num_heads, scale,
                                     add_residual, residual_scale)


def reference_swin_block_full(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                              proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                              ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                              window_size: int, num_heads: int, scale: float):
    """The plain PyTorch version of ``fused_swin_block_full``."""
    y = x + reference_swin_attn_block(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                                      proj_weight, proj_bias, rel_bias, mask, window_size,
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
    out = _launch_joint(*args)
    fused_swin_block_full.launches += 1
    return out


fused_swin_block_full.launches = 0


# ------------------------------------------------------------------ launches
_SIGNATURES = {
    # after (dtype, x, out) / (dtype, x, dz, dx): ints, pointers, ...
    'swin_block_joint_fwd': lambda p, i, f: [i, p, p] + [i] * 7 + [p] * 14 + [f, p],
    'swin_attn_block_fwd': lambda p, i, f: [i, p, p] + [i] * 6 + [p] * 8 + [i, p, f, p],
    'swin_attn_block_bwd': lambda p, i, f: [i, p, p, p] + [i] * 6 + [p] * 7 + [i, p, f, p, p],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _launch.bind(name, _SIGNATURES[name](p, i, ctypes.c_float), [i, i],
                        [i, i, i] if name == 'swin_attn_block_bwd' else None)


def _attention_operands(op, x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                        rel_bias, mask, window_size, num_heads):
    """Checked operands of the attention half: [ln_weight, ln_bias, qkv_weight,
    qkv_bias, proj_weight], rel_bias, mask or None."""
    _launch.check_activation(x, 'x', op)
    if x.dim() != 4:
        raise ValueError(f'{op}: x must be a (B, H, W, C) tensor')
    _, h, w, c = x.shape
    n = window_size * window_size
    if h % window_size or w % window_size:
        raise ValueError(f'{op}: {h}x{w} is not a multiple of the window {window_size}')
    if n > MAX_TOKENS_PER_WINDOW:
        raise ValueError(f'{op}: window {window_size} has more than '
                         f'{MAX_TOKENS_PER_WINDOW} tokens')
    if c % num_heads or c % 4 or (c // num_heads) % 2:
        raise ValueError(f'{op}: needs C % heads == 0, C % 4 == 0 and an even head dim '
                         f'(C={c}, heads={num_heads})')
    dev, f32 = x.device, torch.float32
    ops = [_launch.operand(ln_weight, 'ln_weight', (c,), f32, dev),
           _launch.operand(ln_bias, 'ln_bias', (c,), f32, dev),
           _launch.operand(qkv_weight, 'qkv_weight', (3 * c, c), x.dtype, dev),
           _launch.operand(qkv_bias, 'qkv_bias', (3 * c,), f32, dev),
           _launch.operand(proj_weight, 'proj_weight', (c, c), x.dtype, dev)]
    rel_bias = _launch.operand(rel_bias, 'rel_bias', (num_heads, n, n), f32, dev)
    if mask is not None:
        mask = _launch.operand(mask, 'mask', ((h // window_size) * (w // window_size), n, n),
                               f32, dev)
    return ops, rel_bias, mask


def _launch_joint(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                  rel_bias, mask: Optional[torch.Tensor], ln2_weight, ln2_bias, fc1_weight,
                  fc1_bias, fc2_weight, fc2_bias, window_size, num_heads, scale):
    op = 'swin_block_joint_fwd'
    tensors = (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
               rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
               fc2_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError('fused_swin_block_full: the joint kernel has no backward; '
                                  'run under torch.no_grad(), or train through '
                                  'fused_swin_attn_block and fused_mlp_block')
    attn, rel_bias, mask = _attention_operands(op, x, ln1_weight, ln1_bias, qkv_weight,
                                               qkv_bias, proj_weight, rel_bias, mask,
                                               window_size, num_heads)
    b, h, w, c = x.shape
    hidden = fc1_weight.shape[0]
    if hidden % 4:
        raise ValueError(f'{op}: needs hidden % 4 == 0 (hidden={hidden})')
    dev, f32 = x.device, torch.float32
    ops = attn + [
        _launch.operand(proj_bias, 'proj_bias', (c,), f32, dev), rel_bias, mask,
        _launch.operand(ln2_weight, 'ln2_weight', (c,), f32, dev),
        _launch.operand(ln2_bias, 'ln2_bias', (c,), f32, dev),
        _launch.operand(fc1_weight, 'fc1_weight', (hidden, c), x.dtype, dev),
        _launch.operand(fc1_bias, 'fc1_bias', (hidden,), f32, dev),
        _launch.operand(fc2_weight, 'fc2_weight', (c, hidden), x.dtype, dev),
        _launch.operand(fc2_bias, 'fc2_bias', (c,), f32, dev),
    ]
    lib = _lib(op)
    _launch.check_shared_memory(lib.swin_block_joint_fwd_smem_bytes(c, num_heads), dev, op)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = lib.swin_block_joint_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
        window_size, hidden, *_launch.pointers(ops), float(scale),
        _launch.current_stream(dev))
    _launch.check_rc(rc, lib, op)
    return out


def _launch_attn_forward(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                         rel_bias, mask, window_size, num_heads, scale, add_residual,
                         residual_scale):
    op = 'swin_attn_block_fwd'
    ops, rel_bias, mask = _attention_operands(op, x, ln_weight, ln_bias, qkv_weight, qkv_bias,
                                              proj_weight, rel_bias, mask, window_size,
                                              num_heads)
    b, h, w, c = x.shape
    ops += [_launch.operand(proj_bias, 'proj_bias', (c,), torch.float32, x.device), rel_bias,
            mask]
    lib = _lib(op)
    _launch.check_shared_memory(lib.swin_attn_block_fwd_smem_bytes(c, num_heads), x.device, op)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = lib.swin_attn_block_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
        window_size, *_launch.pointers(ops), _launch.mode_of(add_residual, residual_scale),
        *_launch.pointers([_launch.scale_operand(residual_scale, x)]), float(scale),
        _launch.current_stream(x.device))
    _launch.check_rc(rc, lib, op)
    return out


def _launch_attn_backward(x, dz, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight,
                          rel_bias, mask, window_size, num_heads, scale, add_residual,
                          residual_scale):
    op = 'swin_attn_block_bwd'
    ops, rel_bias, mask = _attention_operands(op, x, ln_weight, ln_bias, qkv_weight, qkv_bias,
                                              proj_weight, rel_bias, mask, window_size,
                                              num_heads)
    _launch.check_activation(dz, 'dz', op)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(f'{op}: dz must match x in shape, dtype and device')
    b, h, w, c = x.shape
    n = window_size * window_size
    ops += [rel_bias, mask]
    lib = _lib(op)
    _launch.check_shared_memory(lib.swin_attn_block_bwd_smem_bytes(c, num_heads), x.device, op)
    dx = torch.empty_like(x)
    # one float32 buffer for every parameter gradient; the op zeroes it on the stream
    grads = torch.empty(lib.swin_attn_block_bwd_grad_floats(c, num_heads, window_size),
                        dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        grads.zero_()
    else:
        rc = lib.swin_attn_block_bwd(
            _launch.DTYPES[x.dtype], x.data_ptr(), dz.data_ptr(), dx.data_ptr(), b, h, w, c,
            num_heads, window_size, *_launch.pointers(ops),
            _launch.mode_of(add_residual, residual_scale),
            *_launch.pointers([_launch.scale_operand(residual_scale, x)]), float(scale),
            grads.data_ptr(), _launch.current_stream(x.device))
        _launch.check_rc(rc, lib, op)
    dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj, drel = grads.split(
        [c, c, 3 * c * c, 3 * c, c * c, c, num_heads * n * n])
    return (dx, dln_w, dln_b, dwqkv.view(3 * c, c), dbqkv, dwproj.view(c, c), dbproj,
            drel.view(num_heads, n, n))
