"""Post-training int8 inference (W8A8), counterpart of
``basicsr4rs_tpu/ops/quant.py``.

    with quantized_inference(net):
        out = net(lq)                      # eligible convolutions now run in int8

or per config: ``val: {quant_int8: true | 'static'}`` routes a model's
evaluation through it (``models/sr_model.py``).

Scheme, as in the JAX package:

- weights: symmetric absmax / 127 per output channel, from the live
  parameters at every call;
- activations: symmetric absmax / 127 per tensor, **dynamic** by default or
  **static** from the absmax that ``calibrate_act_scales`` saw;
- accumulation in exact integers, dequantised as
  ``acc * (s_x * s_w[c_out]) + bias`` in float32 and cast to the input's type.

PyTorch has no method interception, so the scope takes the network: for its
lifetime every eligible ``nn.Conv2d`` (by the name ``named_modules()`` gives
it) has an int8 ``forward`` as an instance attribute, and loses it on exit,
exceptions included. Parameters and ``state_dict`` are untouched. Kept in
the original precision: convolutions with fewer than ``min_channels`` input
or output channels (``conv_first`` from RGB, ``conv_last`` to RGB), grouped,
dilated, transposed, other than two-dimensional or padded other than with
zeros, inputs that are not 4-D, and, under static scales, a site that the
calibration did not see.

The integer product is exact on both devices: float64 on the CPU, where
every partial sum is an integer below 2^53, and im2col + ``torch._int_mm``
(int8 x int8 -> int32) on a card. No float32 or TF32 convolution touches it.

On a band of rows (``parallel: {spatial: N}``) the archs hand a rewritten
convolution the band with its halo rows and the padding of the rows taken
off (``archs/arch_util.halo_conv``, ``int8_forward_of``); a dynamic scale,
and a calibrated absmax, is then the maximum over every band
(``parallel/halo.max_over_bands``), the whole map's, as the JAX package's
per-tensor absmax of the sharded map is.

``swin_kernels=True`` also switches SwinIR's joint block to its W8A8 kernel
(``ops.swin_block.fused_swin_block_full(..., quant_int8=True)``), which the
arch asks through ``swin_kernels_int8()``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.halo import max_over_bands

_QMAX = 127.0
_MISSING = object()


def quantize_weight_int8(w: torch.Tensor, reduce_dims) -> tuple:
    """Symmetric absmax quantisation per output channel: (w_int8, scale
    float32), the scale reduced over ``reduce_dims`` (kept as size-1
    dimensions so that it broadcasts against ``w``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = amax.clamp_min(1e-12) / _QMAX
    wq = torch.clamp(torch.round(wf / scale), -_QMAX, _QMAX)
    return wq.to(torch.int8), scale


def quantize_act_int8(x: torch.Tensor, scale=None) -> tuple:
    """Symmetric int8 quantisation of an activation per tensor: dynamic
    absmax when ``scale`` is None, else the given static scale."""
    xf = x.float()
    if scale is None:
        scale = xf.abs().amax().clamp_min(1e-12) / _QMAX
    xq = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
    return xq.to(torch.int8), scale


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def int_conv2d_gemm(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """Exact int32 convolution of int8 operands as im2col + one
    ``torch._int_mm``: the card's route. M, K and N are padded with zeros
    to what the integer GEMM takes (M > 16, K and N multiples of 8)."""
    b, _, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    # int8 values are exact in float16, which im2col takes on every device
    cols = F.unfold(xq.to(torch.float16), (kh, kw), padding=padding, stride=stride)
    k, positions = cols.shape[1], cols.shape[2]
    m = b * positions
    a = torch.zeros((max(_round_up(m, 8), 24), _round_up(k, 8)), dtype=torch.int8,
                    device=xq.device)
    a[:m, :k] = cols.transpose(1, 2).reshape(m, k)
    bmat = torch.zeros((a.shape[1], _round_up(cout, 8)), dtype=torch.int8, device=xq.device)
    bmat[:k, :cout] = wq.reshape(cout, k).t()
    acc = torch._int_mm(a, bmat)[:m, :cout]
    out_h = (h + 2 * padding[0] - kh) // stride[0] + 1
    out_w = (w + 2 * padding[1] - kw) // stride[1] + 1
    return acc.reshape(b, out_h, out_w, cout).permute(0, 3, 1, 2)


def int_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """Exact int32 convolution of int8 x (B, Cin, H, W) with int8 weights
    (Cout, Cin, kh, kw), zero padding: float64 on the CPU,
    ``int_conv2d_gemm`` on a card. Both give the same integers."""
    if xq.device.type == 'cpu':
        return F.conv2d(xq.double(), wq.double(), None, stride, padding).to(torch.int32)
    return int_conv2d_gemm(xq, wq, stride, padding)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride=(1, 1), padding=(1, 1), act_scale=None) -> torch.Tensor:
    """W8A8 2-D convolution: x (B, Cin, H, W), weight (Cout, Cin, kh, kw);
    int8 operands, exact integer accumulation, float32 dequantisation; x's type."""
    xq, sx = quantize_act_int8(x, act_scale)
    wq, sw = quantize_weight_int8(weight, (1, 2, 3))
    acc = int_conv2d(xq, wq, tuple(stride), tuple(padding))
    y = acc.float() * (sx * sw.view(1, -1, 1, 1))
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def _canonical_padding(conv: nn.Conv2d):
    """(pad_h, pad_w) of a zero-padded convolution, None when it is not one
    this module rewrites."""
    if conv.padding_mode != 'zeros':
        return None
    padding = conv.padding
    if isinstance(padding, str):
        if padding == 'valid':
            return (0, 0)
        if padding == 'same' and all(k % 2 == 1 for k in conv.kernel_size):
            return tuple(k // 2 for k in conv.kernel_size)
        return None
    return tuple(int(p) for p in padding)


def conv_eligible(module: nn.Module, min_channels: int) -> bool:
    """Whether ``quantized_inference`` rewrites this module."""
    if not isinstance(module, nn.Conv2d):          # 2-D, not transposed
        return False
    if min(module.in_channels, module.out_channels) < min_channels:
        return False                               # image-boundary convolutions
    if module.groups != 1 or tuple(module.dilation) != (1, 1):
        return False
    return _canonical_padding(module) is not None


def _int8_forward(conv: nn.Conv2d, name: str, original: Callable, act_scales, record, x,
                  padding=None):
    """The rewritten forward. ``padding``: a band with its halo rows
    (``halo_conv``), convolved with this (rows, columns) padding in place of
    the convolution's own, its absmax the whole map's."""
    if x.dim() != 4:
        return original(x)

    def unquantised():
        if padding is None:
            return original(x)
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, padding)

    def absmax():
        amax = x.float().abs().amax()
        return amax if padding is None else max_over_bands(amax)

    if record is not None:      # calibration: keep the absmax, run in full precision
        record[name] = max(record.get(name, 0.0), float(absmax()))
        return unquantised()
    act_scale = None
    if act_scales is not None:
        amax = act_scales.get(name)
        if amax is None:        # a site the calibration did not see
            return unquantised()
        act_scale = max(amax, 1e-12) / _QMAX
    elif padding is not None:
        act_scale = absmax().clamp_min(1e-12) / _QMAX
    return int8_conv2d(x, conv.weight, conv.bias, conv.stride,
                       _canonical_padding(conv) if padding is None else padding, act_scale)


def int8_forward_of(conv: nn.Module) -> Optional[Callable]:
    """The forward a ``quantized_inference`` or calibration scope put on
    ``conv`` (it takes ``padding=``), or None."""
    forward = conv.__dict__.get('forward')
    if isinstance(forward, functools.partial) and forward.func is _int8_forward:
        return forward
    return None


@contextlib.contextmanager
def _swapped_forwards(net: nn.Module, min_channels: int, act_scales, record):
    swapped = []
    try:
        for name, module in net.named_modules():
            if conv_eligible(module, min_channels):
                swapped.append((module, module.__dict__.get('forward', _MISSING)))
                module.forward = functools.partial(_int8_forward, module, name, module.forward,
                                                   act_scales, record)
        yield
    finally:
        for module, previous in swapped:
            if previous is _MISSING:
                del module.forward
            else:
                module.forward = previous


_SWIN_INT8 = False


def swin_kernels_int8() -> bool:
    """True inside a ``quantized_inference(..., swin_kernels=True)`` scope:
    SwinIR's blocks then run the W8A8 joint kernel at evaluation."""
    return _SWIN_INT8


@contextlib.contextmanager
def quantized_inference(net: nn.Module, min_channels: int = 16,
                        act_scales: Optional[Dict[str, float]] = None,
                        swin_kernels: bool = False):
    """Scope in which every eligible ``nn.Conv2d`` of ``net`` runs as a W8A8
    convolution.

    ``act_scales``: {module name: absmax} from ``calibrate_act_scales``,
    which switches the activation scales from dynamic to static; a site
    missing from it stays in the original precision. ``swin_kernels``: also
    run SwinIR's joint block through its W8A8 kernel; nested scopes restore
    the outer one's choice."""
    global _SWIN_INT8
    previous = _SWIN_INT8
    _SWIN_INT8 = bool(swin_kernels)
    try:
        with _swapped_forwards(net, min_channels, act_scales, None):
            yield
    finally:
        _SWIN_INT8 = previous


def calibrate_act_scales(net: nn.Module, apply_fn: Callable, batches: Iterable,
                         min_channels: int = 16) -> Dict[str, float]:
    """Run ``apply_fn(batch)`` in full precision over ``batches`` and return
    {module name: largest absmax seen at its input} for every convolution
    that ``quantized_inference`` would rewrite; feed it back as ``act_scales``."""
    record: Dict[str, float] = {}
    with _swapped_forwards(net, min_channels, None, record):
        for batch in batches:
            apply_fn(batch)
    return record
