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
  as one deform group: the warped map itself; ``warp_by_flow`` the same for
  a flow (N, H, W, 2), which the kernel reads through its strides
  (``offset_layout``), so ``flow_warp`` builds no grid and no offset.

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
    flow: bool = False   # the offset is a flow (N, Ho, Wo, 2), last dimension (dx, dy)

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        return ((h + 2 * self.padding - self.dilation * (self.kh - 1) - 1) // self.stride + 1,
                (w + 2 * self.padding - self.dilation * (self.kw - 1) - 1) // self.stride + 1)


WARP = SampleGeometry(1, 1, 1, 0, 1, 1)
FLOW_WARP = WARP._replace(flow=True)


class OffsetLayout(NamedTuple):
    """Where the sampler finds the (dy, dx) pair of sample n, deform group
    g, tap k and output pixel p = ho * Wo + wo, in float32 elements from the
    offset's first element: dy at ``start + n * batch + (g * K + k) * tap +
    p * pixel``, dx ``pair`` elements from it (before it when negative)."""
    start: int
    batch: int
    tap: int
    pair: int
    pixel: int


def flow_operand(flow: torch.Tensor) -> torch.Tensor:
    """A flow (N, H, W, 2) as the sampler reads it: itself when it is
    float32 and its pixels flatten to one stride (a contiguous flow, or
    ``flow.permute(0, 2, 3, 1)`` of a contiguous (N, 2, H, W) one), else a
    contiguous float32 copy."""
    _, h, w, _ = flow.shape
    if flow.dtype == torch.float32 and (h == 1 or flow.stride(1) == w * flow.stride(2)):
        return flow
    return flow.float().contiguous()


def offset_layout(offset: torch.Tensor, geo: SampleGeometry) -> OffsetLayout:
    """The layout of a float32 offset: BasicSR's (N, G * 2K, Ho, Wo),
    contiguous; or, for ``geo.flow``, a flow (N, Ho, Wo, 2) with last
    dimension (dx, dy) as ``flow_operand`` gives it, so dy is one channel
    stride past dx: start s_c, pair -s_c."""
    return _layout_of(offset.shape, offset.stride(), geo.flow)


def _layout_of(shape, stride, flow: bool) -> OffsetLayout:
    if flow:
        s_n, _, s_w, s_c = stride
        return OffsetLayout(s_c, s_n, 0, -s_c, s_w)
    _, channels, ho, wo = shape
    p = ho * wo
    return OffsetLayout(0, channels * p, 2 * p, p, 1)


def offset_pairs(offset: torch.Tensor, geo: SampleGeometry) -> torch.Tensor:
    """BasicSR's offset (N, G * 2K, Ho, Wo) read from ``offset``'s storage
    through its ``offset_layout``, by ``torch.as_strided`` (the pair
    dimension flipped where dx comes first): the offset the kernel sees."""
    layout = offset_layout(offset, geo)
    n = offset.shape[0]
    ho, wo = offset.shape[1:3] if geo.flow else offset.shape[2:]
    pairs = geo.deform_groups * geo.kh * geo.kw
    view = torch.as_strided(
        offset, (n, pairs, 2, ho, wo),
        (layout.batch, layout.tap, abs(layout.pair), wo * layout.pixel, layout.pixel),
        offset.storage_offset() + layout.start + min(0, layout.pair))
    if layout.pair < 0:
        view = view.flip(2)
    return view.reshape(n, 2 * pairs, ho, wo)


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
    gradient) and zero outside (-1, H) x (-1, W). A flow (``geo.flow``) is
    read as the kernel reads it (``offset_pairs``)."""
    if geo.flow:
        offset, geo = offset_pairs(flow_operand(offset), geo), geo._replace(flow=False)
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
    if not x.is_cuda:
        if x.device.type == 'cpu':
            return reference_deform_sample(x, offset, mask, geo)
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


class _FlowWarp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, flow):
        x = x if x.is_contiguous() else x.contiguous()
        ctx.save_for_backward(x, flow)
        return deform_sample_forward(x, flow, None, FLOW_WARP).view(x.shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, flow = ctx.saved_tensors
        need_x, need_flow = ctx.needs_input_grad
        # K9 takes the offset as a contiguous (N, 2, H, W), built once here
        offset = offset_pairs(flow_operand(flow), FLOW_WARP).contiguous()
        dx, doffset, _ = deform_sample_backward(
            x, offset, None, dout.to(x.dtype).contiguous().unsqueeze(2), WARP, need_dx=need_x,
            need_doffset=need_flow)
        dflow = None if doffset is None else doffset.flip(1).permute(0, 2, 3, 1).to(flow.dtype)
        return dx, dflow


def warp_by_flow(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) sampled bilinearly at (h + dy, w + dx), zero outside
    the map, for a flow (N, H, W, 2) with last dimension (dx, dy) in pixels:
    one launch of the sampler, which reads the flow through its strides, so
    the position is h + dy in one rounding; differentiable in both."""
    if torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad):
        return _FlowWarp.apply(x, flow)
    x = x if x.is_contiguous() else x.contiguous()
    return deform_sample_forward(x, flow, None, FLOW_WARP).view(x.shape)


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
    if op == 'deform_sample_fwd':   # the integers as one array (_forward_dims)
        return _launch.bind(op, [i] + [p] * 6, None)
    return _launch.bind(op, [i] + [p] * 7 + [i] * 12 + [p], None)


def _check_activation(t, name: str, op: str) -> None:
    """The kernels read single elements, so they ask for no alignment."""
    if t.dim() != 4 and t.dim() != 5:
        raise ValueError(f'{op}: {name} must be a 4-d map or a 5-d column tensor')
    if t.dtype not in _launch.DTYPES:
        raise TypeError(f'{op}: {name} must be float32 or bfloat16, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{op}: {name} must be contiguous')


@functools.lru_cache(maxsize=256)
def _plan(op: str, shape, geo: SampleGeometry):
    """(the kernels' integers, the offset's shape, the mask's shape, the
    column tensor's shape) for x of ``shape`` under ``geo``, computed once
    per shape; raises for a shape the kernels do not take (their indices
    are 32-bit where these sizes allow, addresses 64-bit)."""
    if len(shape) != 4 or shape[1] % geo.deform_groups:
        raise ValueError(f'{op}: x {tuple(shape)} does not split into '
                         f'{geo.deform_groups} deform groups')
    n, c, h, w = shape
    ho, wo = geo.out_size(h, w)
    taps = geo.kh * geo.kw
    pairs = geo.deform_groups * taps
    if n * c * h * w >= 2**31 or n * c * taps >= 2**31:
        raise ValueError(f'{op}: x {tuple(shape)} is too large for 32-bit indices')
    ints = (n, c, h, w, ho, wo, geo.kh, geo.kw, geo.stride, geo.padding, geo.dilation,
            geo.deform_groups)
    offset = (n, ho, wo, 2) if geo.flow else (n, 2 * pairs, ho, wo)
    return ints, torch.Size(offset), torch.Size((n, pairs, ho, wo)), (n, c, taps, ho, wo)


def _check_shapes(op: str, x, offset, mask, geo: SampleGeometry):
    """Raise unless offset and mask fit x and the geometry; ``_plan``'s
    integers and the column tensor's shape."""
    ints, offset_shape, mask_shape, col_shape = _plan(op, x.shape, geo)
    for name, t, want in (('offset', offset, offset_shape), ('mask', mask, mask_shape)):
        if t is not None and t.shape != want:
            raise ValueError(f'{op}: {name} must be {tuple(want)}, got {tuple(t.shape)}')
        if t is not None and t.get_device() != x.get_device():
            raise ValueError(f'{op}: {name} is on {t.device}, x on {x.device}')
    return ints, col_shape


def _float32(t):
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _operands(op: str, x, offset, mask, geo: SampleGeometry):
    """The float32 offset and mask, checked (copied only where they are not
    float32 or not in the layout the kernels read), the geometry's integers
    and the column tensor's shape."""
    _check_activation(x, 'x', op)
    ints, col_shape = _check_shapes(op, x, offset, mask, geo)
    offset = flow_operand(offset) if geo.flow else _float32(offset)
    if mask is not None:
        mask = _float32(mask)
    return offset, mask, ints, col_shape


@functools.lru_cache(maxsize=256)
def _forward_dims(shape, geo: SampleGeometry, offset_shape, offset_stride):
    """The forward launch's integers, the geometry and then the offset's
    layout, as one C array made once per shape and layout, and its address
    (valid while the caller holds the array)."""
    layout = _layout_of(offset_shape, offset_stride, geo.flow)
    reach = max(layout.start, layout.start + layout.pair) + sum(
        (size - 1) * stride for size, stride in zip(offset_shape, offset_stride))
    if reach >= 2**31:
        raise ValueError('deform_sample_fwd: the offset is too large for 32-bit indices')
    dims = (ctypes.c_int * 17)(*_plan('deform_sample_fwd', shape, geo)[0], *layout)
    return dims, ctypes.addressof(dims)


def _launch_forward(x, offset, mask, geo: SampleGeometry):
    op = 'deform_sample_fwd'
    offset, mask, _, col_shape = _operands(op, x, offset, mask, geo)
    dims, address = _forward_dims(x.shape, geo, offset.shape, offset.stride())
    col = torch.empty(col_shape, dtype=x.dtype, device=x.device)
    if col.numel() == 0:
        return col
    lib = _lib(op)
    rc = lib.deform_sample_fwd(_launch.DTYPES[x.dtype], x.data_ptr(), offset.data_ptr(),
                               None if mask is None else mask.data_ptr(), col.data_ptr(),
                               address, _launch.stream_of(x))
    _launch.check_rc(rc, lib, op)
    return col


def _launch_backward(x, offset, mask, dcol, geo: SampleGeometry, need_dx, need_doffset):
    op = 'deform_sample_bwd'
    if geo.flow:
        raise ValueError(f'{op}: takes BasicSR\'s offset; a flow goes through offset_pairs')
    offset, mask, ints, want = _operands(op, x, offset, mask, geo)
    _check_activation(dcol, 'dcol', op)
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
