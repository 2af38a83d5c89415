"""3x3 same-padding convolution with its epilogue as one CUDA kernel, and
its plain twin.

Counterpart of ``basicsr4rs_tpu/ops/conv3x3.py``, with the port's shapes:
x (B, Cin, H, W), weight (Cout, Cin, 3, 3) as ``nn.Conv2d`` keeps it.

    out = conv3x3(x, weight) + bias (+ residual) ; leaky_relu(out, act_slope) if given

``fused_conv3x3`` sends a CUDA tensor to ``csrc/conv3x3_fwd.cu`` (any H, W,
Cin, Cout; float32 or bfloat16 with float32 accumulation) and a CPU tensor
to ``reference_conv3x3``; it never hands a CUDA tensor to a library
convolution. Layouts: the kernel reads x, the residual and the weight
channels-last and writes channels-last, as the JAX kernel does (NHWC). x and
the residual may come in either memory format: a channels-last one, such as
SwinIR's ``tokens.transpose(1, 2).reshape(b, c, h, w)``, goes in with no
copy, a contiguous NCHW one is converted inside the call. The output is
``torch.channels_last`` on both devices, so ``out.flatten(2).transpose(1, 2)``
is already a contiguous token tensor. The wrapper re-lays the weight as
(Cout, 3, 3, Cin) in x's type (``nn.Conv2d``'s weight in channels-last
memory) on every call: one copy of the weight's size that is part of the
call's time. float32 runs on the tensor cores as 3xTF32 (see the kernel's
source); ``torch.backends.cudnn.allow_tf32`` plays no part.
The backward has no kernel, as in the JAX package: the standard convolution
gradients through PyTorch's library in float32, with the cotangent gated by
the sign of the saved output when ``act_slope`` is set (a leaky-ReLU with a
positive slope keeps the sign) and the residual's gradient equal to that
gated cotangent. ``fused_conv3x3.launches`` counts the kernel's launches.
The forward is the operator ``basicsr4rs::conv3x3_fwd`` (``ops/library.py``).
On a band of rows (``parallel: {spatial: N}``, ``parallel/halo.py``) the
archs do not call it: their 3x3 convolutions take halo rows and run
PyTorch's convolution (``archs/arch_util.halo_conv``), as the JAX kernel
gives way to XLA on a spatial mesh.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import _launch, library


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


CHANNELS_LAST = torch.channels_last
BLOCK_N = (64, 128, 192)  # output channels of a block the kernel is built for


def channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its memory is channels-last, else a channels-last copy."""
    return t if t.is_contiguous(memory_format=CHANNELS_LAST) else t.contiguous(
        memory_format=CHANNELS_LAST)


def block_channels(cout: int) -> int:
    """Output channels of a kernel block: all of Cout up to 192 (SwinIR-M's
    180 in one block of 192), wider maps in blocks of 128."""
    return next((n for n in BLOCK_N if cout <= n), 128)


def copy_bytes(cin: int, element_size: int, address: int) -> int:
    """The widest copy of a pixel's or an output channel's Cin channels the
    kernel may make (16, 8 or 4 bytes): it must divide their bytes and the
    tensor's alignment; 0 (element by element) when none does (bfloat16
    with an odd Cin)."""
    return next((n for n in (16, 8, 4) if (cin * element_size) % n == 0 and address % n == 0), 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _launch.bind('conv3x3_fwd', [i, p, p, p, p, p] + [i] * 9 + [ctypes.c_float, p], [i])


@functools.lru_cache(maxsize=None)
def smem_bytes(block_n: int) -> int:
    """Dynamic shared memory of a kernel block of ``block_n`` output channels."""
    return _lib().conv3x3_fwd_smem_bytes(block_n)


def _launch_forward(x, weight, bias, residual, act_slope):
    op = 'conv3x3_fwd'
    if x.dtype not in _launch.DTYPES:
        raise TypeError(f'{op}: x must be float32 or bfloat16, got {x.dtype}')
    if x.dim() != 4:
        raise ValueError(f'{op}: x must be a (B, Cin, H, W) tensor')
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f'{op}: weight must be (Cout, {cin}, 3, 3), got {tuple(weight.shape)}')
    if weight.device != x.device:
        raise ValueError(f'{op}: weight is on {weight.device}, x on {x.device}')
    if b * h * w >= 2**31:
        raise ValueError(f'{op}: at most 2**31 - 1 pixels a launch, got {b * h * w}')
    dev, dt = x.device, x.dtype
    x = channels_last(x)
    # (Cout, 3, 3, Cin) in memory: K-major rows of the GEMM's second operand
    w_t = weight.detach().to(dtype=dt, memory_format=CHANNELS_LAST)
    if not w_t.permute(0, 2, 3, 1).is_contiguous():
        w_t = w_t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    bias = _launch.operand(bias, 'bias', (cout,), torch.float32, dev)
    if residual is not None:
        if residual.shape != (b, cout, h, w) or residual.dtype != dt or residual.device != dev:
            raise ValueError(f'{op}: residual must be {(b, cout, h, w)} of x\'s type and device')
        residual = channels_last(residual)
    out = torch.empty((b, cout, h, w), dtype=dt, device=dev, memory_format=CHANNELS_LAST)
    if out.numel() == 0:
        return out
    block_n, es = block_channels(cout), x.element_size()
    _launch.check_shared_memory(smem_bytes(block_n), dev, op)
    lib = _lib()
    rc = lib.conv3x3_fwd(_launch.DTYPES[dt], x.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
                         None if residual is None else residual.data_ptr(), out.data_ptr(),
                         b, cin, cout, h, w, block_n, copy_bytes(cin, es, x.data_ptr()),
                         copy_bytes(cin, es, w_t.data_ptr()), int(act_slope is not None),
                         float(act_slope or 0.), _launch.current_stream(dev))
    _launch.check_rc(rc, lib, op)
    return out


def conv3x3_forward(x, weight, bias, residual=None, act_slope: Optional[float] = None):
    """The convolution and its epilogue in one kernel launch; no autograd.
    The output is channels-last. The op ``basicsr4rs::conv3x3_fwd``: its
    launches count in ``fused_conv3x3.launches``."""
    library.check_device(x, 'fused_conv3x3')
    return torch.ops.basicsr4rs.conv3x3_fwd.default(
        x, weight, bias, residual, None if act_slope is None else float(act_slope))


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
    slope ``act_slope`` when given; (B, Cout, H, W) in x's type and
    channels-last, differentiable in x, weight, bias and residual. x and
    ``residual`` may be in either memory format. One kernel launch on a CUDA
    tensor, the plain version on a CPU tensor."""
    if residual is not None:
        residual = residual.to(x.dtype)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, residual)):
        return _FusedConv3x3.apply(x, weight, bias, residual, act_slope)
    return conv3x3_forward(x, weight, bias, residual, act_slope)


fused_conv3x3.launches = 0


# ------------------------------------------------------------------- the op
def _forward_cpu(x, weight, bias, residual, act_slope):
    out = reference_conv3x3(x, weight, bias, residual, act_slope)
    return torch.empty_like(out, memory_format=CHANNELS_LAST).copy_(out)


def _forward_cuda(x, weight, bias, residual, act_slope):
    out = _launch_forward(x, weight, bias, residual, act_slope)
    fused_conv3x3.launches += 1
    return out


def _forward_fake(x, weight, bias, residual=None, act_slope=None):
    return torch.empty((x.shape[0], weight.shape[0], *x.shape[2:]), dtype=x.dtype,
                       device=x.device, memory_format=CHANNELS_LAST)


library.define('conv3x3_fwd', 'Tensor x, Tensor weight, Tensor bias, Tensor? residual, '
               'float? act_slope', _forward_cpu, _forward_cuda, _forward_fake)
