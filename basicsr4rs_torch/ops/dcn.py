"""Modulated deformable convolution (DCNv2) and the one-tap bilinear warp,
over a deformable bilinear sampler written as CUDA kernels, and their plain
twins.

Counterpart of ``basicsr4rs_tpu/ops/dcn.py`` (reference: basicsr/ops/dcn).
NCHW activations, OIHW weights, BasicSR's channel layout: offset channels
``g * 2K + 2k + {0: dy, 1: dx}`` and mask channels ``g * K + k`` for deform
group g and tap k = i * kw + j of K = kh * kw.

- ``deform_sample_forward`` is one launch of ``csrc/deform_sample_fwd.cu``:
  from x (N, C, H, W), offset (N, G * 2K, Ho, Wo) and an optional mask
  (N, G * K, Ho, Wo) the column tensor (N, C, K, Ho, Wo) of bilinear samples,
  zero outside the map, times the mask;
- ``deform_sample_backward`` is one launch of ``csrc/deform_sample_bwd.cu``:
  from the column tensor's cotangent, dx (summed with float32 atomics, so
  not bit for bit the same from run to run), doffset and dmask;
- ``deform_sample`` is the ``torch.autograd.Function`` over the two;
- ``modulated_deform_conv`` is the sampler and one (grouped) matrix product
  with the weight, which stays ``torch.matmul``;
- ``bilinear_warp`` is the sampler with one tap, the whole channel dimension
  as one deform group: the warped map itself.

Every wrapper sends a CUDA tensor to its kernel and a CPU tensor to its plain
PyTorch version (``reference_*``), and counts its launches in ``.launches``.
x may be float32 or bfloat16; samples are blended in float32 and returned in
x's type, gradients are summed in float32 and cast once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..utils.logger import get_root_logger
from ..utils.registry import ARCH_REGISTRY
from . import _launch


class SampleGeometry(NamedTuple):
    """The convolution whose taps the sampler visits."""
    kh: int
    kw: int
    stride: int = 1
    padding: int = 1
    dilation: int = 1
    deform_groups: int = 1

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        return ((h + 2 * self.padding - self.dilation * (self.kh - 1) - 1) // self.stride + 1,
                (w + 2 * self.padding - self.dilation * (self.kw - 1) - 1) // self.stride + 1)


WARP = SampleGeometry(1, 1, 1, 0, 1, 1)


# ------------------------------------------------------------ plain versions
def _positions(offset: torch.Tensor, geo: SampleGeometry):
    """(py, px), each (N, G, K, Ho, Wo) float32, in the map's coordinates."""
    n, _, ho, wo = offset.shape
    k2 = geo.kh * geo.kw
    off = offset.float().reshape(n, geo.deform_groups, k2, 2, ho, wo)
    dev = offset.device
    taps = torch.arange(k2, device=dev)
    base_y = (torch.arange(ho, device=dev) * geo.stride - geo.padding).view(1, ho, 1)
    base_x = (torch.arange(wo, device=dev) * geo.stride - geo.padding).view(1, 1, wo)
    tap_y = (torch.div(taps, geo.kw, rounding_mode='floor') * geo.dilation).view(k2, 1, 1)
    tap_x = ((taps % geo.kw) * geo.dilation).view(k2, 1, 1)
    py = (base_y + tap_y).float() + off[:, :, :, 0]
    px = (base_x + tap_x).float() + off[:, :, :, 1]
    return py, px


def reference_deform_sample(x: torch.Tensor, offset: torch.Tensor,
                            mask: Optional[torch.Tensor], geo: SampleGeometry) -> torch.Tensor:
    """The plain PyTorch version of ``deform_sample_forward``: four corner
    reads by ``gather``, blended in float32. Differentiable; autograd gives
    the one-sided position gradient at whole positions (the floor has no
    gradient) and zero outside (-1, H) x (-1, W)."""
    n, c, h, w = x.shape
    ho, wo = offset.shape[-2:]
    dg, k2 = geo.deform_groups, geo.kh * geo.kw
    cpg = c // dg
    py, px = _positions(offset, geo)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = (py - y0).unsqueeze(2), (px - x0).unsqueeze(2)
    inside = ((py > -1) & (py < h) & (px > -1) & (px < w)).unsqueeze(2)
    y0, x0 = y0.long(), x0.long()
    maps = x.float().reshape(n, dg, cpg, h * w)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).unsqueeze(2)
        index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, dg, 1, -1)
        values = torch.gather(maps, 3, index.expand(-1, -1, cpg, -1))
        return values.reshape(n, dg, cpg, k2, ho, wo) * valid

    top = corner(y0, x0) * (1 - lx) + corner(y0, x0 + 1) * lx
    bottom = corner(y0 + 1, x0) * (1 - lx) + corner(y0 + 1, x0 + 1) * lx
    col = (top * (1 - ly) + bottom * ly) * inside
    if mask is not None:
        col = col * mask.float().reshape(n, dg, 1, k2, ho, wo)
    return col.to(x.dtype).reshape(n, c, k2, ho, wo)


def reference_deform_sample_backward(x, offset, mask, dcol, geo: SampleGeometry,
                                     need_dx: bool = True, need_doffset: bool = True):
    """The plain PyTorch version of ``deform_sample_backward``: (dx, doffset,
    dmask) by autograd through ``reference_deform_sample``; dx in x's type,
    the others float32; None for what is not needed."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        offset = offset.detach().float().requires_grad_()
        inputs = [x, offset]
        if mask is not None:
            mask = mask.detach().float().requires_grad_()
            inputs.append(mask)
        col = reference_deform_sample(x, offset, mask, geo)
        grads = torch.autograd.grad(col, inputs, dcol)
    return (grads[0] if need_dx else None, grads[1] if need_doffset else None,
            grads[2] if need_doffset and mask is not None else None)


# ------------------------------------------------------------------ wrappers
def deform_sample_forward(x, offset, mask, geo: SampleGeometry) -> torch.Tensor:
    """The column tensor (N, C, K, Ho, Wo) in one kernel launch; no autograd."""
    if x.device.type == 'cpu':
        return reference_deform_sample(x, offset, mask, geo)
    if x.device.type != 'cuda':
        raise ValueError(f'deform_sample_forward: no kernel for device {x.device}')
    col = _launch_forward(x, offset, mask, geo)
    deform_sample_forward.launches += 1
    return col


deform_sample_forward.launches = 0


def deform_sample_backward(x, offset, mask, dcol, geo: SampleGeometry, need_dx: bool = True,
                           need_doffset: bool = True):
    """(dx, doffset, dmask) from the column tensor's cotangent in one kernel
    launch: dx in x's type, doffset and dmask float32; a gradient that is not
    needed (and dmask without a mask) is None."""
    if x.device.type == 'cpu':
        return reference_deform_sample_backward(x, offset, mask, dcol, geo, need_dx,
                                                need_doffset)
    if x.device.type != 'cuda':
        raise ValueError(f'deform_sample_backward: no kernel for device {x.device}')
    grads = _launch_backward(x, offset, mask, dcol, geo, need_dx, need_doffset)
    deform_sample_backward.launches += 1
    return grads


deform_sample_backward.launches = 0


class _DeformSample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, offset, mask, geo):
        x, offset = x.contiguous(), offset.contiguous()
        mask = None if mask is None else mask.contiguous()
        ctx.save_for_backward(x, offset, mask)
        ctx.geo = geo
        return deform_sample_forward(x, offset, mask, geo)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dcol):
        x, offset, mask = ctx.saved_tensors
        need_x, need_offset, need_mask = ctx.needs_input_grad[:3]
        dx, doffset, dmask = deform_sample_backward(
            x, offset, mask, dcol.to(x.dtype).contiguous(), ctx.geo, need_dx=need_x,
            need_doffset=need_offset or need_mask)
        if doffset is not None:
            doffset = doffset.to(offset.dtype)
        if dmask is not None:
            dmask = dmask.to(mask.dtype)
        return dx, doffset, dmask, None


def deform_sample(x, offset, mask, geo: SampleGeometry) -> torch.Tensor:
    """The column tensor (N, C, K, Ho, Wo) of x (N, C, H, W) sampled at the
    taps of ``geo`` moved by ``offset``, times ``mask`` (or None);
    differentiable in all three, forward and backward one kernel launch each
    on a CUDA tensor."""
    _check_shapes('deform_sample', x, offset, mask, geo)
    return _DeformSample.apply(x, offset, mask, geo)


# ------------------------------------------------------------- the operators
def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                          deform_groups: int = 1) -> torch.Tensor:
    """DCNv2 forward (v1 when ``mask`` is None).

    Args:
      x: (N, Cin, H, W), float32 or bfloat16.
      offset: (N, 2 * dg * kh * kw, Ho, Wo), BasicSR's channel layout.
      mask: (N, dg * kh * kw, Ho, Wo) in [0, 1], or None.
      weight: (Cout, Cin // groups, kh, kw).
    Returns (N, Cout, Ho, Wo) in x's type, whatever the weight's.
    """
    n, cin = x.shape[:2]
    cout, cig, kh, kw = weight.shape
    if cin != cig * groups or cout % groups:
        raise ValueError(f'modulated_deform_conv: weight {tuple(weight.shape)} does not fit '
                         f'{cin} input channels in {groups} groups')
    geo = SampleGeometry(kh, kw, stride, padding, dilation, deform_groups)
    col = deform_sample(x, offset, mask, geo)                     # (N, Cin, K, Ho, Wo)
    ho, wo = col.shape[-2:]
    col = col.reshape(n, groups, cig * kh * kw, ho * wo)
    w = weight.to(x.dtype).reshape(groups, cout // groups, cig * kh * kw)
    out = torch.matmul(w, col).reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def bilinear_warp(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                  border: bool = False) -> torch.Tensor:
    """x (N, C, H, W) sampled bilinearly at the positions py, px (N, H, W),
    given in pixels: zero outside the map, or, with ``border``, the positions
    clamped to the map first (the clamp passes no gradient beyond it)."""
    n, _, h, w = x.shape
    if border:
        py = py.clamp(0., h - 1.)
        px = px.clamp(0., w - 1.)
    grid_y = torch.arange(h, device=x.device, dtype=py.dtype).view(1, h, 1)
    grid_x = torch.arange(w, device=x.device, dtype=px.dtype).view(1, 1, w)
    offset = torch.stack([py - grid_y, px - grid_x], dim=1)
    return deform_sample(x, offset, None, WARP).reshape(x.shape)


# --------------------------------------------------------------- the modules
class ModulatedDeformConvPack(nn.Module):
    """DCNv2 whose offsets and masks come from the same input through
    ``conv_offset``, which starts at zero."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                 deformable_groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.deformable_groups = groups, deformable_groups
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.conv_offset = nn.Conv2d(in_channels, deformable_groups * 3 * k * k, k, stride,
                                     padding, dilation)
        stdv = 1. / math.sqrt(in_channels * k * k)
        nn.init.uniform_(self.weight, -stdv, stdv)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def _offset_and_mask(self, feat):
        o1, o2, mask = torch.chunk(self.conv_offset(feat), 3, dim=1)
        return torch.cat((o1, o2), dim=1), torch.sigmoid(mask)

    def _dcn(self, x, offset, mask):
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias, self.stride,
                                     self.padding, self.dilation, self.groups,
                                     self.deformable_groups)

    def forward(self, x):
        offset, mask = self._offset_and_mask(x)
        return self._dcn(x, offset, mask)


@ARCH_REGISTRY.register()
class DCNv2Pack(ModulatedDeformConvPack):
    """DCNv2 whose offsets and masks come from a separate feature (EDVR's
    PCD alignment). With ``log_offset`` set it warns, as BasicSR does, when
    the mean absolute offset exceeds 50; reading that mean waits for the
    device, so it is off unless ``train.log_dcn_offset`` asks for it."""

    log_offset = False

    def forward(self, x, feat):
        offset, mask = self._offset_and_mask(feat)
        if self.log_offset:
            offset_absmean = float(offset.detach().abs().mean())
            if offset_absmean > 50:
                get_root_logger().warning(f'Offset abs mean is {offset_absmean}, larger than 50.')
        return self._dcn(x, offset, mask)


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _lib(op: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    pointers = 4 if op == 'deform_sample_fwd' else 7
    return _launch.bind(op, [i] + [p] * pointers + [i] * 12 + [p], None)


def _check_activation(t, name: str, op: str) -> None:
    """The kernels read single elements, so they ask for no alignment."""
    if t.dim() != 4 and t.dim() != 5:
        raise ValueError(f'{op}: {name} must be a 4-d map or a 5-d column tensor')
    if t.dtype not in _launch.DTYPES:
        raise TypeError(f'{op}: {name} must be float32 or bfloat16, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{op}: {name} must be contiguous')


def _check_shapes(op: str, x, offset, mask, geo: SampleGeometry) -> Tuple[int, int]:
    """Raise unless offset and mask fit x and the geometry; (Ho, Wo)."""
    if x.dim() != 4 or x.shape[1] % geo.deform_groups:
        raise ValueError(f'{op}: x {tuple(x.shape)} does not split into '
                         f'{geo.deform_groups} deform groups')
    ho, wo = geo.out_size(*x.shape[-2:])
    taps = geo.deform_groups * geo.kh * geo.kw
    for name, t, channels in (('offset', offset, 2 * taps), ('mask', mask, taps)):
        want = (x.shape[0], channels, ho, wo)
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f'{op}: {name} must be {want}, got {tuple(t.shape)}')
        if t is not None and t.device != x.device:
            raise ValueError(f'{op}: {name} is on {t.device}, x on {x.device}')
    return ho, wo


def _operands(op: str, x, offset, mask, geo: SampleGeometry):
    """The float32 offset and mask, checked, and the geometry's integers."""
    _check_activation(x, 'x', op)
    ho, wo = _check_shapes(op, x, offset, mask, geo)
    offset = offset.detach().float().contiguous()
    if mask is not None:
        mask = mask.detach().float().contiguous()
    n, c, h, w = x.shape
    ints = (n, c, h, w, ho, wo, geo.kh, geo.kw, geo.stride, geo.padding, geo.dilation,
            geo.deform_groups)
    return offset, mask, ints


def _launch_forward(x, offset, mask, geo: SampleGeometry):
    op = 'deform_sample_fwd'
    offset, mask, ints = _operands(op, x, offset, mask, geo)
    lib = _lib(op)
    n, c, ho, wo = ints[0], ints[1], ints[4], ints[5]
    col = torch.empty((n, c, geo.kh * geo.kw, ho, wo), dtype=x.dtype, device=x.device)
    if col.numel() == 0:
        return col
    rc = lib.deform_sample_fwd(_launch.DTYPES[x.dtype], *_launch.pointers([x, offset, mask, col]),
                               *ints, _launch.current_stream(x.device))
    _launch.check_rc(rc, lib, op)
    return col


def _launch_backward(x, offset, mask, dcol, geo: SampleGeometry, need_dx, need_doffset):
    op = 'deform_sample_bwd'
    offset, mask, ints = _operands(op, x, offset, mask, geo)
    _check_activation(dcol, 'dcol', op)
    n, c, ho, wo = ints[0], ints[1], ints[4], ints[5]
    want = (n, c, geo.kh * geo.kw, ho, wo)
    if tuple(dcol.shape) != want or dcol.dtype != x.dtype or dcol.device != x.device:
        raise ValueError(f'{op}: dcol must be {want} in x\'s dtype and on its device')
    lib = _lib(op)
    # the op zeroes dx on the stream before the kernel adds to it
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device) if need_dx else None
    doffset = torch.empty_like(offset) if need_doffset else None
    dmask = torch.empty_like(mask) if need_doffset and mask is not None else None
    if x.numel() == 0 or dcol.numel() == 0:
        return tuple(None if t is None else t.zero_() for t in (dx, doffset, dmask))
    rc = lib.deform_sample_bwd(
        _launch.DTYPES[x.dtype], *_launch.pointers([x, offset, mask, dcol, dx, doffset, dmask]),
        *ints, _launch.current_stream(x.device))
    _launch.check_rc(rc, lib, op)
    return (None if dx is None else dx.to(x.dtype)), doffset, dmask
