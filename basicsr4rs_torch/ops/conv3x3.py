"""3x3 same-padding convolution with its epilogue as one CUDA kernel, and
its plain twin.

Counterpart of ``basicsr4rs_tpu/ops/conv3x3.py``, on the port's layout:
x (B, Cin, H, W), weight (Cout, Cin, 3, 3) as ``nn.Conv2d`` keeps it.

    out = conv3x3(x, weight) + bias (+ residual) ; leaky_relu(out, act_slope) if given

``fused_conv3x3`` sends a CUDA tensor to ``csrc/conv3x3_fwd.cu`` (any H, W,
Cin, Cout; float32 or bfloat16 with float32 accumulation) and a CPU tensor
to ``reference_conv3x3``; it never hands a CUDA tensor to a library
convolution. The wrapper re-lays the weight as (Cin, 3, 3, Cout) in x's type
on every call, a copy of the weight's size that is part of the call's time.
The backward has no kernel, as in the JAX package: the standard convolution
gradients through PyTorch's library in float32, with the cotangent gated by
the sign of the saved output when ``act_slope`` is set (a leaky-ReLU with a
positive slope keeps the sign) and the residual's gradient equal to that
gated cotangent. ``fused_conv3x3.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import _launch


def conv_fusion_enabled() -> bool:
    """Whether the archs route their 3x3 convolutions through
    ``fused_conv3x3`` (``SWIN_FUSED_CONV=1``; default off)."""
    return os.environ.get('SWIN_FUSED_CONV', '0') == '1'


def reference_conv3x3(x, weight, bias, residual=None, act_slope: Optional[float] = None):
    """The plain PyTorch version of ``fused_conv3x3``: ``F.conv2d`` + add +
    ``F.leaky_relu`` in float32 on the operands rounded to x's type, the
    result rounded once to x's type."""
    dt = x.dtype
    out = F.conv2d(x.float(), weight.to(dt).float(), bias.float(), stride=1, padding=1)
    if residual is not None:
        out = out + residual.float()
    if act_slope is not None:
        out = F.leaky_relu(out, act_slope)
    return out.to(dt)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _launch.bind('conv3x3_fwd', [i, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p],
                        None)


def _launch_forward(x, weight, bias, residual, act_slope):
    op = 'conv3x3_fwd'
    _launch.check_activation(x, 'x', op)
    if x.dim() != 4:
        raise ValueError(f'{op}: x must be a (B, Cin, H, W) tensor')
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f'{op}: weight must be (Cout, {cin}, 3, 3), got {tuple(weight.shape)}')
    if weight.device != x.device:
        raise ValueError(f'{op}: weight is on {weight.device}, x on {x.device}')
    if b > 65535:
        raise ValueError(f'{op}: at most 65535 samples a launch, got {b}')
    dev = x.device
    w_t = weight.detach().to(x.dtype).permute(1, 2, 3, 0).contiguous()
    bias = _launch.operand(bias, 'bias', (cout,), torch.float32, dev)
    if residual is not None:
        _launch.check_activation(residual, 'residual', op)
        if (tuple(residual.shape) != (b, cout, h, w) or residual.dtype != x.dtype
                or residual.device != dev):
            raise ValueError(f'{op}: residual must be {(b, cout, h, w)} of x\'s type and device')
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.conv3x3_fwd(_launch.DTYPES[x.dtype], x.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
                         None if residual is None else residual.data_ptr(), out.data_ptr(),
                         b, cin, cout, h, w, int(act_slope is not None),
                         float(act_slope or 0.), _launch.current_stream(dev))
    _launch.check_rc(rc, lib, op)
    return out


def conv3x3_forward(x, weight, bias, residual=None, act_slope: Optional[float] = None):
    """The convolution and its epilogue in one kernel launch; no autograd."""
    if x.device.type == 'cpu':
        return reference_conv3x3(x, weight, bias, residual, act_slope)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_conv3x3: no kernel for device {x.device}')
    out = _launch_forward(x, weight, bias, residual, act_slope)
    fused_conv3x3.launches += 1
    return out


class _FusedConv3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, residual, act_slope):
        out = conv3x3_forward(x, weight, bias, residual, act_slope)
        ctx.save_for_backward(x, weight, out if act_slope is not None else None)
        ctx.act_slope = act_slope
        ctx.bias_dtype = bias.dtype
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        x, weight, out = ctx.saved_tensors
        dzf = dz.float()
        if ctx.act_slope is not None:
            dzf = torch.where(out >= 0, dzf, ctx.act_slope * dzf)
        need = ctx.needs_input_grad
        dx, dw, db = torch.ops.aten.convolution_backward(
            dzf, x.float(), weight.float(), [weight.shape[0]], [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [need[0], need[1], need[2]])
        return (dx.to(x.dtype) if need[0] else None, dw.to(weight.dtype) if need[1] else None,
                db.to(ctx.bias_dtype) if need[2] else None,
                dzf.to(dz.dtype) if ctx.has_residual and need[3] else None, None)


def fused_conv3x3(x, weight, bias, residual=None, act_slope: Optional[float] = None):
    """3x3, stride 1, zero-padded convolution of x (B, Cin, H, W) with
    ``weight`` (Cout, Cin, 3, 3) and ``bias`` (Cout,), plus ``residual``
    (B, Cout, H, W) when given (added after the bias), then a leaky-ReLU of
    slope ``act_slope`` when given; (B, Cout, H, W) in x's type,
    differentiable in x, weight, bias and residual. One kernel launch on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_contiguous():
        x = x.contiguous()
    if residual is not None:
        residual = residual.to(x.dtype).contiguous()
    return _FusedConv3x3.apply(x, weight, bias, residual, act_slope)


fused_conv3x3.launches = 0
