"""The Swin transformer block as CUDA kernels, and their plain twins.

Counterpart of ``basicsr4rs_tpu/ops/swin_block.py``. For x (B, H, W, C)
already rolled by the caller:

- ``fused_swin_block_full`` computes the whole block,

      y   = x + s1 * proj(W-MSA(LN1(x)))   # relative-position bias + shift mask
      out = y + s2 * fc2(GELU(fc1(LN2(y))))

  in one launch of ``csrc/swin_block_joint_fwd.cu`` (s1, s2: DropPath's
  per-sample scales, 1 without them). Its backward recomputes y with the
  attention branch's forward kernel and runs the MLP's and the attention
  branch's backward kernels with the residual (or the scale) folded, as
  the JAX package's joint VJP does. With ``quant_int8=True`` it is the W8A8
  serving variant, one launch of ``csrc/swin_block_joint_int8_fwd.cu``
  (``swin_block_full_int8``), which has no backward.
- ``fused_swin_attn_block`` (training, and SwinIR's eval past the joint
  kernel's widths) is the attention branch ``proj(W-MSA(LN(x)))`` as a
  ``torch.autograd.Function`` over ``swin_attn_block_forward``
  (``csrc/swin_attn_block_fwd.cu``: two launches, (window, head) units, then
  proj on token tiles) and ``swin_attn_block_backward``
  (``csrc/swin_attn_block_bwd.cu``), with the output modes of
  ``ops.mlp_block``: the branch alone, ``+ x``, or ``s[b] * branch + x``.

Every wrapper sends a CUDA tensor to its kernel and a CPU tensor to its
plain PyTorch version (``reference_*``), and counts its launches in
``.launches``. The two float forwards do so as the operators
``basicsr4rs::swin_block_joint_fwd`` and ``basicsr4rs::swin_attn_block_fwd``
(``ops/library.py``), so that ``torch.export`` keeps each as one node; with
gradients off, ``fused_swin_block_full`` and ``fused_swin_attn_block`` are
those forwards alone. Weights are in the ``nn.Linear`` (out, in) layout and are cast
to x's dtype; LayerNorm parameters and biases are used in float32. The
attention bias comes as the relative-position bias (heads, n, n) and the
shift mask (nW, n, n) or None, so that nothing passed in grows with the
image.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from . import _launch, library
from .mlp_block import fold_branch, layer_norm_f32, mlp_block_backward, reference_mlp_block
from .quant import quantize_weight_int8
from .window_attention import reference_window_attention

MAX_TOKENS_PER_WINDOW = 64
# the joint kernels hold proj's and fc2's outputs in registers, 6 n8 tiles a
# warp (csrc/swin_block_joint.cuh: kMaxN), and pad a head to 32 features
JOINT_MAX_CHANNELS, JOINT_MAX_HEAD_DIM = 192, 32
# past them the int8 kernel runs its wide variant: 8 n8 tiles a warp, heads
# padded to 64 features (kWideMaxN, kWideMaxHeadDim)
INT8_MAX_CHANNELS, INT8_MAX_HEAD_DIM = 256, 64


def joint_block_takes(channels: int, num_heads: int) -> bool:
    """Whether the float joint kernel takes a block of this width:
    C <= JOINT_MAX_CHANNELS and a head dim <= JOINT_MAX_HEAD_DIM."""
    return channels <= JOINT_MAX_CHANNELS and channels // num_heads <= JOINT_MAX_HEAD_DIM


def int8_block_takes(channels: int, num_heads: int) -> bool:
    """Whether the int8 joint kernel takes a block of this width:
    C <= INT8_MAX_CHANNELS and a head dim <= INT8_MAX_HEAD_DIM."""
    return channels <= INT8_MAX_CHANNELS and channels // num_heads <= INT8_MAX_HEAD_DIM
# the attention backward holds dL/dLN(x)'s outputs in registers, 8 n8 tiles a
# warp, and dO's, 3 a warp (csrc/swin_attn_block_bwd.cu): wider blocks than
# any whose shared memory its first route could hold
ATTN_BWD_MAX_CHANNELS, ATTN_BWD_MAX_HEAD_DIM = 256, 96


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
    """The attention branch of x (B, H, W, C) in one kernel launch; no
    autograd. The op ``basicsr4rs::swin_attn_block_fwd``: its launches count
    in ``swin_attn_block_forward.launches``."""
    library.check_device(x, 'swin_attn_block_forward')
    return torch.ops.basicsr4rs.swin_attn_block_fwd.default(
        x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias, mask,
        int(window_size), int(num_heads), float(scale), bool(add_residual), residual_scale)


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
        return (*(_launch.grad_like(g, p) for g, p in zip(grads, like)), None, None, None, None,
                None, None)


def fused_swin_attn_block(x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                          rel_bias, mask, window_size: int, num_heads: int, scale: float,
                          add_residual: bool = False, residual_scale=None):
    """proj(W-MSA(LN(x))) for x (B, H, W, C) already rolled, differentiable;
    forward and backward are one kernel launch each on a CUDA tensor.

    ``rel_bias``: (heads, n, n) relative-position bias with n = window_size**2;
    ``mask``: (nW, n, n) 0/-100 shift mask for the nW windows of one image,
    or None (no gradient). ``add_residual`` returns ``x + branch``;
    ``residual_scale`` (B,) float32, DropPath's mask / keep per sample,
    returns ``x + s[b] * branch`` and gets no gradient. With gradients off
    it is ``swin_attn_block_forward`` itself, which ``torch.export`` keeps as
    one node."""
    args = (x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias, mask,
            window_size, num_heads, scale, add_residual, residual_scale)
    if not torch.is_grad_enabled():
        return swin_attn_block_forward(*args)
    return _FusedSwinAttnBlock.apply(*args)


def joint_train_enabled() -> bool:
    """Whether training also routes through the joint kernel and its
    recomputing backward (``SWIN_JOINT_TRAIN=1``; default off, the split
    pair of branch kernels)."""
    return os.environ.get('SWIN_JOINT_TRAIN', '0') == '1'


def reference_swin_block_full(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                              proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                              ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                              window_size: int, num_heads: int, scale: float,
                              residual_scales=None):
    """The plain PyTorch version of ``swin_block_full_forward``."""
    s1, s2 = residual_scales if residual_scales is not None else (None, None)
    y = reference_swin_attn_block(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                                  proj_weight, proj_bias, rel_bias, mask, window_size,
                                  num_heads, scale, s1 is None, s1)
    return reference_mlp_block(y, ln2_weight, ln2_bias, fc1_weight, fc1_bias,
                               fc2_weight, fc2_bias, s2 is None, s2)


def swin_block_full_forward(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                            proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                            ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                            window_size: int, num_heads: int, scale: float,
                            residual_scales=None):
    """The whole block of x (B, H, W, C) in one kernel launch; no autograd.
    The op ``basicsr4rs::swin_block_joint_fwd``: each launch adds one to
    ``fused_swin_block_full.launches``."""
    library.check_device(x, 'fused_swin_block_full')
    s1, s2 = residual_scales if residual_scales is not None else (None, None)
    return torch.ops.basicsr4rs.swin_block_joint_fwd.default(
        x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias, mask,
        ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, int(window_size),
        int(num_heads), float(scale), s1, s2)


class _FusedSwinBlockFull(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
                fc2_bias, window_size, num_heads, scale, s1, s2):
        ctx.save_for_backward(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight,
                              proj_bias, rel_bias, mask, ln2_weight, ln2_bias, fc1_weight,
                              fc1_bias, fc2_weight, fc2_bias, s1, s2)
        ctx.geometry = (window_size, num_heads, scale)
        return swin_block_full_forward(
            x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias,
            mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
            window_size, num_heads, scale, None if s1 is None else (s1, s2))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias, mask,
         ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, s1,
         s2) = ctx.saved_tensors
        attn = (ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight)
        mlp = (ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight)
        # y = x + s1 * attention branch, recomputed rather than kept
        y = swin_attn_block_forward(x, *attn, proj_bias, rel_bias, mask, *ctx.geometry,
                                    s1 is None, s1)
        dy, *mlp_grads = mlp_block_backward(y, dz.to(x.dtype).contiguous(), *mlp, s2 is None,
                                            s2)
        dx, *attn_grads = swin_attn_block_backward(x, dy, *attn, rel_bias, mask, *ctx.geometry,
                                                   s1 is None, s1)
        like_attn = (*attn, proj_bias, rel_bias)
        like_mlp = (*mlp, fc2_bias)
        return (dx, *(_launch.grad_like(g, p) for g, p in zip(attn_grads, like_attn)), None,
                *(_launch.grad_like(g, p) for g, p in zip(mlp_grads, like_mlp)), None, None,
                None, None, None)


def fused_swin_block_full(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                          proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                          ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                          window_size: int, num_heads: int, scale: float,
                          quant_int8: bool = False, residual_scales=None):
    """The whole Swin block (attention + residual, MLP + residual) for x
    (B, H, W, C), already rolled; returns (B, H, W, C) in x's dtype.

    ``rel_bias``: (heads, n, n) relative-position bias with n = window_size**2;
    ``mask``: (nW, n, n) 0/-100 shift mask for the nW windows of one image,
    or None (no gradient). ``residual_scales``: (s1, s2), each (B,) float32,
    DropPath's mask / keep per sample for the two branches, without
    gradient: ``y = x + s1 * attn; out = y + s2 * mlp``. Differentiable: the
    forward is one launch of the joint kernel
    (``fused_swin_block_full.launches``), the backward one launch each of
    ``swin_attn_block_forward``, ``mlp_block_backward`` and
    ``swin_attn_block_backward``. ``quant_int8``: the W8A8 serving variant
    ``swin_block_full_int8`` (no gradient, no scales)."""
    if quant_int8:
        if residual_scales is not None:
            raise ValueError('fused_swin_block_full: the int8 block takes no DropPath scales')
        return swin_block_full_int8(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight,
                                    proj_bias, rel_bias, mask, ln2_weight, ln2_bias, fc1_weight,
                                    fc1_bias, fc2_weight, fc2_bias, window_size, num_heads,
                                    scale)
    block = (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias,
             mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
             window_size, num_heads, scale)
    if not torch.is_grad_enabled():   # the op alone, which torch.export keeps as one node
        return swin_block_full_forward(*block, residual_scales)
    s1, s2 = residual_scales if residual_scales is not None else (None, None)
    return _FusedSwinBlockFull.apply(*block, s1, s2)


fused_swin_block_full.launches = 0


# --------------------------------------------------------------- W8A8 block
_QUANT_CACHE = {}


def _quantize_rows(weight):
    """(int8 (out, round_up(in, 16)) zero-padded, float32 (out,) scales) of an
    ``nn.Linear`` weight, quantised per output row."""
    wq, s = quantize_weight_int8(weight, (1,))
    return F.pad(wq, (0, -wq.shape[1] % 16)).contiguous(), s.reshape(-1).contiguous()


def quantized_block_weights(qkv_weight, proj_weight, fc1_weight, fc2_weight):
    """(qkv_q, qkv_s, proj_q, proj_s, fc1_q, fc1_s, fc2_q, fc2_s) of a block's
    four weights, each quantised per output row; kept until one of the four
    changes (its storage or its version counter)."""
    weights = (qkv_weight, proj_weight, fc1_weight, fc2_weight)
    if any(w.is_inference() for w in weights):   # no version counter to watch
        return tuple(t for w in weights for t in _quantize_rows(w.detach()))
    key = id(qkv_weight)
    signature = tuple((id(w), w.data_ptr(), w._version) for w in weights)
    hit = _QUANT_CACHE.get(key)
    if hit is not None and hit[0]() is qkv_weight and hit[1] == signature:
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():
        packed = tuple(t for w in weights for t in _quantize_rows(w.detach()))
    ref = weakref.ref(qkv_weight, lambda _, key=key: _QUANT_CACHE.pop(key, None))
    _QUANT_CACHE[key] = (ref, signature, packed)
    return packed


def _quantize_windows(v, window_size: int):
    """The float32 map v (B, H, W, K) quantised with one dynamic scale per
    window: (q, s, r), all float32; r = v * (1 / s) before rounding and
    q = clip(round(r)), both (B, H/ws, ws, W/ws, ws, K); s =
    max(absmax, 1e-12) * (1 / 127), broadcasting against them, as the kernel
    computes them."""
    b, h, w, k = v.shape
    ws = window_size
    t = v.reshape(b, h // ws, ws, w // ws, ws, k)
    s = t.abs().amax(dim=(2, 4, 5), keepdim=True).clamp_min(1e-12) * (1. / 127.)
    r = t * (1. / s)
    return torch.clamp(torch.round(r), -127., 127.), s, r


def _int8_linear(v, wq, sw, bias, window_size: int, given=None, quantised=None):
    """``acc * (s_x * s_w) + bias`` of the window-quantised v against int8
    rows ``wq`` with scales ``sw``; the sum is exact (float32 holds
    K * 127^2 up to K = 1040, float64 beyond). ``quantised``: a list that
    receives (q int8 (B, H, W, K), s (B, H/ws, W/ws), r) of this v; ``given``:
    a (q, s) of those shapes that the product uses in place of its own."""
    k = v.shape[-1]
    q, s, r = _quantize_windows(v, window_size)
    if quantised is not None:
        quantised.append((q.reshape(v.shape).to(torch.int8), s[:, :, 0, :, 0, 0],
                          r.reshape(v.shape)))
    if given is not None:
        q, s = given[0].reshape(q.shape).float(), given[1].reshape(s.shape)
    exact = torch.float32 if k * 127 * 127 < 2**24 else torch.float64
    acc = (q.to(exact) @ wq[:, :k].to(exact).t()).float()
    return (acc * (s * sw) + bias.float()).reshape(*v.shape[:-1], wq.shape[0])


def reference_swin_block_full_int8(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                                   proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                                   ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                                   window_size: int, num_heads: int, scale: float,
                                   quantised=None, given=None):
    """The plain PyTorch version of ``swin_block_full_int8``: the same
    quantisation (per output row for weights, per window for the activation
    entering each of the four products), exact integer sums, float32
    elsewhere.

    ``quantised``: a list that receives, for qkv, proj, fc1 and fc2 in turn,
    (q, s, r): the int8 input (B, H, W, K) of the product, its scales
    (B, H/ws, W/ws) and the unrounded r = v / s that q was rounded from.
    ``given``: four (q, s) that the products use in place of their own, so
    that each r is what this version finds downstream of another's integers."""
    dt, ws = x.dtype, window_size
    qkv_q, qkv_s, proj_q, proj_s, fc1_q, fc1_s, fc2_q, fc2_s = quantized_block_weights(
        qkv_weight, proj_weight, fc1_weight, fc2_weight)
    g = given if given is not None else (None,) * 4
    xn = layer_norm_f32(x, ln1_weight, ln1_bias)
    qkv = _int8_linear(xn, qkv_q, qkv_s, qkv_bias, ws, g[0], quantised).to(dt)
    a = reference_window_attention(qkv, _attention_bias(rel_bias, mask), ws, num_heads, scale)
    y = _int8_linear(a.float(), proj_q, proj_s, proj_bias, ws, g[1], quantised) + x.float()
    hidden = F.gelu(_int8_linear(layer_norm_f32(y, ln2_weight, ln2_bias), fc1_q, fc1_s,
                                 fc1_bias, ws, g[2], quantised))
    return (_int8_linear(hidden, fc2_q, fc2_s, fc2_bias, ws, g[3], quantised) + y).to(dt)


def swin_block_full_int8(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias,
                         proj_weight, proj_bias, rel_bias, mask, ln2_weight,
                         ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                         window_size: int, num_heads: int, scale: float, quantised=None):
    """The whole Swin block with qkv, proj, fc1 and fc2 as int8 x int8 ->
    int32 products, for x (B, H, W, C) already rolled, in one kernel launch
    (``swin_block_full_int8.launches``) for C <= 256 and heads of up to 64
    features (``int8_block_takes``); serving only, it raises when autograd
    needs a gradient.

    Weights are quantised per output channel (absmax / 127) outside the
    kernel, once until a weight changes. The activation entering each
    product is quantised with a dynamic scale absmax / 127 (floor 1e-12,
    round half to even, clip +-127) **per window of window_size**2 tokens**,
    the tile this kernel holds; the JAX kernel's tile is a row of windows
    sized for its memory, so the two agree in kind, not number by number.
    Dequantised as ``acc * (s_x * s_w[col]) + bias`` in float32; LayerNorm,
    softmax, GELU, the residuals and q.k / p.v are as in the float block.

    ``quantised``: for checks, a list that receives what the same launch
    quantised: for qkv, proj, fc1 and fc2 in turn (q, s), the product's int8
    input (B, H, W, K) and its scales (B, H/ws, W/ws)."""
    args = (x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
            rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, window_size, num_heads, scale)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in args):
        raise NotImplementedError('swin_block_full_int8: the int8 block has no backward; '
                                  'run it under torch.no_grad()')
    if x.device.type == 'cpu':
        own = None if quantised is None else []
        out = reference_swin_block_full_int8(*args, quantised=own)
        if own is not None:
            quantised.extend((q, s) for q, s, _ in own)
        return out
    if x.device.type != 'cuda':
        raise ValueError(f'swin_block_full_int8: no kernel for device {x.device}')
    out = _launch_joint_int8(*args, quantised)
    swin_block_full_int8.launches += 1
    return out


swin_block_full_int8.launches = 0


# ------------------------------------------------------------------ launches
_SIGNATURES = {
    # after (dtype, x, out) / (dtype, x, dz, dx): ints, pointers, ...
    'swin_block_joint_fwd': lambda p, i, f: [i, p, p] + [i] * 7 + [p] * 16 + [f, p],
    'swin_block_joint_int8_fwd': lambda p, i, f: [i, p, p] + [i] * 7 + [p] * 18 + [f, p, p, p],
    'swin_attn_block_fwd': lambda p, i, f: [i, p, p] + [i] * 6 + [p] * 8 + [i, p, f, p, p],
    'swin_attn_block_bwd': lambda p, i, f: [i, p, p, p] + [i] * 6 + [p] * 7 + [i, p, f, p, p, p],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    smem = {'swin_block_joint_fwd': [i, i, i], 'swin_block_joint_int8_fwd': [i, i, i, i],
            'swin_attn_block_fwd': [i, i, i, i], 'swin_attn_block_bwd': [i, i, i]}
    return _launch.bind(name, _SIGNATURES[name](p, i, ctypes.c_float), smem[name],
                        [i, i, i] if name == 'swin_attn_block_bwd' else None)


@functools.lru_cache(maxsize=None)
def attn_forward_shared_memory(dtype: torch.dtype, channels: int, num_heads: int):
    """Bytes of shared memory a block of each of the attention forward's two
    launches takes: the (window, head) units, then proj's token tiles."""
    lib = _lib('swin_attn_block_fwd')
    return tuple(lib.swin_attn_block_fwd_smem_bytes(_launch.DTYPES[dtype], channels, num_heads,
                                                    launch) for launch in (0, 1))


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


def _joint_operands(op, x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                    rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
                    fc2_bias, window_size, num_heads, int8=False):
    """Checked operands of the whole block in the kernels' order, weights in
    x's dtype; raises past the widths of the float kernel, or of the int8
    kernel with ``int8``."""
    attn, rel_bias, mask = _attention_operands(op, x, ln1_weight, ln1_bias, qkv_weight,
                                               qkv_bias, proj_weight, rel_bias, mask,
                                               window_size, num_heads)
    c = x.shape[-1]
    hidden = fc1_weight.shape[0]
    if hidden % 4:
        raise ValueError(f'{op}: needs hidden % 4 == 0 (hidden={hidden})')
    takes, limits = ((int8_block_takes, (INT8_MAX_CHANNELS, INT8_MAX_HEAD_DIM)) if int8 else
                     (joint_block_takes, (JOINT_MAX_CHANNELS, JOINT_MAX_HEAD_DIM)))
    if not takes(c, num_heads):
        raise ValueError(f'{op}: takes C <= {limits[0]} and a head dim <= {limits[1]} '
                         f'(C={c}, heads={num_heads})')
    dev, f32 = x.device, torch.float32
    return attn + [
        _launch.operand(proj_bias, 'proj_bias', (c,), f32, dev), rel_bias, mask,
        _launch.operand(ln2_weight, 'ln2_weight', (c,), f32, dev),
        _launch.operand(ln2_bias, 'ln2_bias', (c,), f32, dev),
        _launch.operand(fc1_weight, 'fc1_weight', (hidden, c), x.dtype, dev),
        _launch.operand(fc1_bias, 'fc1_bias', (hidden,), f32, dev),
        _launch.operand(fc2_weight, 'fc2_weight', (c, hidden), x.dtype, dev),
        _launch.operand(fc2_bias, 'fc2_bias', (c,), f32, dev),
    ]


def _launch_joint(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                  rel_bias, mask: Optional[torch.Tensor], ln2_weight, ln2_bias, fc1_weight,
                  fc1_bias, fc2_weight, fc2_bias, window_size, num_heads, scale,
                  residual_scales=None):
    op = 'swin_block_joint_fwd'
    ops = _joint_operands(op, x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight,
                          proj_bias, rel_bias, mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias,
                          fc2_weight, fc2_bias, window_size, num_heads)
    b, h, w, c = x.shape
    s1, s2 = residual_scales if residual_scales is not None else (None, None)
    ops += [_launch.scale_operand(s1, x), _launch.scale_operand(s2, x)]
    lib = _lib(op)
    _launch.check_shared_memory(
        lib.swin_block_joint_fwd_smem_bytes(_launch.DTYPES[x.dtype], c, num_heads), x.device, op)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = lib.swin_block_joint_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
        window_size, fc1_weight.shape[0], *_launch.pointers(ops), float(scale),
        _launch.current_stream(x.device))
    _launch.check_rc(rc, lib, op)
    return out


def _launch_joint_int8(x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias,
                       rel_bias, mask: Optional[torch.Tensor], ln2_weight, ln2_bias, fc1_weight,
                       fc1_bias, fc2_weight, fc2_bias, window_size, num_heads, scale,
                       quantised=None):
    op = 'swin_block_joint_int8_fwd'
    (ln1_weight, ln1_bias, _, qkv_bias, _, proj_bias, rel_bias, mask, ln2_weight, ln2_bias, _,
     fc1_bias, _, fc2_bias) = _joint_operands(
         op, x, ln1_weight, ln1_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, rel_bias,
         mask, ln2_weight, ln2_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, window_size,
         num_heads, int8=True)
    b, h, w, c = x.shape
    hidden = fc1_weight.shape[0]
    qkv_q, qkv_s, proj_q, proj_s, fc1_q, fc1_s, fc2_q, fc2_s = quantized_block_weights(
        qkv_weight, proj_weight, fc1_weight, fc2_weight)
    ops = [ln1_weight, ln1_bias, qkv_q, qkv_s, qkv_bias, proj_q, proj_s, proj_bias, rel_bias,
           mask, ln2_weight, ln2_bias, fc1_q, fc1_s, fc1_bias, fc2_q, fc2_s, fc2_bias]
    lib = _lib(op)
    _launch.check_shared_memory(lib.swin_block_joint_int8_fwd_smem_bytes(
        _launch.DTYPES[x.dtype], c, num_heads, hidden), x.device, op)
    out = torch.empty_like(x)
    quant_q = quant_s = None
    if quantised is not None:
        windows = (b, h // window_size, w // window_size)
        quant_q = torch.empty(b * h * w * (3 * c + hidden), dtype=torch.int8, device=x.device)
        quant_s = torch.empty(4, *windows, device=x.device)
        parts = quant_q.split([b * h * w * k for k in (c, c, c, hidden)])
        quantised.extend((q.view(b, h, w, -1), s) for q, s in zip(parts, quant_s))
    if x.numel() == 0:
        return out
    rc = lib.swin_block_joint_int8_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
        window_size, hidden, *_launch.pointers(ops), float(scale),
        *_launch.pointers([quant_q, quant_s]), _launch.current_stream(x.device))
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
    for needed in attn_forward_shared_memory(x.dtype, c, num_heads):
        _launch.check_shared_memory(needed, x.device, op)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scratch = torch.empty_like(x)   # the attention output, between the two launches
    rc = lib.swin_attn_block_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, c, num_heads,
        window_size, *_launch.pointers(ops), _launch.mode_of(add_residual, residual_scale),
        *_launch.pointers([_launch.scale_operand(residual_scale, x)]), float(scale),
        scratch.data_ptr(), _launch.current_stream(x.device))
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
    if c > ATTN_BWD_MAX_CHANNELS or c // num_heads > ATTN_BWD_MAX_HEAD_DIM:
        raise ValueError(f'{op}: takes C <= {ATTN_BWD_MAX_CHANNELS} and a head dim <= '
                         f'{ATTN_BWD_MAX_HEAD_DIM} (C={c}, heads={num_heads})')
    n = window_size * window_size
    ops += [rel_bias, mask]
    lib = _lib(op)
    dtype = _launch.DTYPES[x.dtype]
    _launch.check_shared_memory(lib.swin_attn_block_bwd_smem_bytes(dtype, c, num_heads),
                                x.device, op)
    dx = torch.empty_like(x)
    # one float32 buffer for every parameter gradient and one for dL/dLN(x)
    # summed over the heads; the op zeroes both on the stream
    grads = torch.empty(lib.swin_attn_block_bwd_grad_floats(c, num_heads, window_size),
                        dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        grads.zero_()
    else:
        scratch = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
        rc = lib.swin_attn_block_bwd(
            dtype, x.data_ptr(), dz.data_ptr(), dx.data_ptr(), b, h, w, c, num_heads,
            window_size, *_launch.pointers(ops), _launch.mode_of(add_residual, residual_scale),
            *_launch.pointers([_launch.scale_operand(residual_scale, x)]), float(scale),
            grads.data_ptr(), scratch.data_ptr(), _launch.stream_of(x))
        _launch.check_rc(rc, lib, op)
    dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj, drel = grads.split(
        [c, c, 3 * c * c, 3 * c, c * c, c, num_heads * n * n])
    return (dx, dln_w, dln_b, dwqkv.view(3 * c, c), dbqkv, dwproj.view(c, c), dbproj,
            drel.view(num_heads, n, n))


# ------------------------------------------------------------------ the ops
# Each implementation takes x contiguous itself: an exported graph keeps the
# callers' ``x.contiguous()`` only where the tracing saw a copy, and a tensor
# the tracing took for contiguous may reach a loaded artifact with other strides.
def _joint_cpu(x, *args):
    *block, s1, s2 = args
    return reference_swin_block_full(x.contiguous(), *block,
                                     None if s1 is None else (s1, s2)).contiguous()


def _joint_cuda(x, *args):
    *block, s1, s2 = args
    out = _launch_joint(x.contiguous(), *block, None if s1 is None else (s1, s2))
    fused_swin_block_full.launches += 1
    return out


def _attn_cpu(x, *args):
    return reference_swin_attn_block(x.contiguous(), *args).contiguous()


def _attn_cuda(x, *args):
    out = _launch_attn_forward(x.contiguous(), *args)
    swin_attn_block_forward.launches += 1
    return out


_ATTENTION_SCHEMA = ('Tensor x, Tensor ln{i}_weight, Tensor ln{i}_bias, Tensor qkv_weight, '
                     'Tensor qkv_bias, Tensor proj_weight, Tensor proj_bias, Tensor rel_bias, '
                     'Tensor? mask')
library.define('swin_block_joint_fwd',
               _ATTENTION_SCHEMA.format(i=1) + ', Tensor ln2_weight, Tensor ln2_bias, '
               'Tensor fc1_weight, Tensor fc1_bias, Tensor fc2_weight, Tensor fc2_bias, '
               'int window_size, int num_heads, float scale, Tensor? s1, Tensor? s2',
               _joint_cpu, _joint_cuda, library.like_x)
library.define('swin_attn_block_fwd',
               _ATTENTION_SCHEMA.format(i='') + ', int window_size, int num_heads, float scale, '
               'bool add_residual, Tensor? residual_scale', _attn_cpu, _attn_cuda,
               library.like_x)
