"""Shared architecture building blocks (counterpart of
``basicsr4rs_tpu/archs/arch_util.py``; reference: basicsr/archs/arch_util.py).
NCHW, BasicSR's module and key layout."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv_fusion_enabled, fused_conv3x3
from ..ops.dcn import bilinear_warp, warp_by_flow
from ..ops.quant import int8_forward_of
from ..parallel.halo import current_shard, halo_rows
from ..utils.dist_util import all_reduce_sum


def trunc_normal_(tensor: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], as the JAX package's
    ``trunc_normal_init``."""
    return nn.init.trunc_normal_(tensor, 0., std, -2 * std, 2 * std, generator=generator)


def default_conv_init_(conv: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """torch's own ``reset_parameters`` distribution of a ``Conv2d`` (and of
    a ``Conv1d`` or ``Linear``, which share it), from ``generator``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
    if conv.bias is not None:
        fan_in = conv.weight[0].numel()
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


@torch.no_grad()
def default_init_weights(module_list, scale: float = 1., bias_fill: float = 0.) -> None:
    """Kaiming-normal weights times ``scale`` and constant biases for every
    convolution and linear layer of the modules (BasicSR's residual-branch
    initialisation)."""
    if not isinstance(module_list, (list, tuple)):
        module_list = [module_list]
    for module in module_list:
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight)
                m.weight.mul_(scale)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)


def halo_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; under a spatial scope (``parallel/halo.py``) on x's band:
    the convolution of the band with ``k // 2`` rows of each neighbouring
    band (zeros past the map's edges), W padded as before and H not at all,
    which is the whole map's convolution cut to the band; inside a W8A8
    scope the convolution's int8 forward takes the haloed band. Stride 1,
    zero padding of ``k // 2`` only (every convolution of the spatial
    networks)."""
    if current_shard() is None:
        return conv(x)
    (kh, _), (ph, pw) = conv.kernel_size, conv.padding
    if (conv.stride != (1, 1) or conv.dilation != (1, 1) or ph != kh // 2
            or conv.padding_mode != 'zeros'):
        raise NotImplementedError(f'halo_conv: {conv} has no spatial route (stride 1, zero '
                                  'padding of k // 2 only)')
    haloed = halo_rows(x, ph, ph)
    int8 = int8_forward_of(conv)
    if int8 is not None:   # inside a W8A8 scope (ops/quant.py)
        return int8(haloed, padding=(0, pw))
    return F.conv2d(haloed, conv.weight, conv.bias, padding=(0, pw), groups=conv.groups)


def make_layer(basic_block: Callable[..., nn.Module], num_basic_block: int,
               **kwarg) -> nn.Sequential:
    """``num_basic_block`` instances of one block in a ``Sequential``."""
    return nn.Sequential(*[basic_block(**kwarg) for _ in range(num_basic_block)])


class ResidualBlockNoBN(nn.Module):
    """conv, ReLU, conv with an identity skip and no normalisation; the
    branch starts at a tenth of the usual scale."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        default_init_weights([self.conv1, self.conv2], 0.1)

    def forward(self, x):
        return x + halo_conv(self.conv2, F.relu(halo_conv(self.conv1, x))) * self.res_scale


def global_batch_moments(x: torch.Tensor):
    """(x minus its mean, the mean, the biased variance) of ``x`` (N, C, ...)
    over every axis but C and the rows of every rank: the mean from the
    ranks' sums and row counts, then the variance from their sums of squared
    deviations, through ``all_reduce_sum`` (whose backward crosses the ranks
    again). One process's own batch in one process."""
    dims, c = (0,) + tuple(range(2, x.dim())), x.shape[1]
    count = x.new_full((1,), x.numel() // c)
    sums = all_reduce_sum(torch.cat([x.sum(dims), count]))
    mean = sums[:c] / sums[c]
    centred = x - mean.view((1, c) + (1,) * (x.dim() - 2))
    sums = all_reduce_sum(torch.cat([centred.square().sum(dims), count]))
    return centred, mean, sums[:c] / sums[c]


class _FlaxBatchStats:
    """BatchNorm whose running variance takes the batch's biased variance,
    as Flax's does; momentum 0.1 in torch's sense (Flax's 0.9). While
    ``update_stats`` is False a train-mode pass normalises by the batch's
    statistics and leaves the running ones as they are.

    With ``sync_ranks`` (``parallel.sync_statistics``, set on a network that
    trains on several ranks) a train-mode pass takes the global batch's
    statistics, as Flax's BatchNorm over the JAX mesh's sharded batch
    (``global_batch_moments``), and the running statistics move from those.
    Flax takes the variance as mean(x^2) - mean(x)^2, which
    loses float32 digits where the mean is large against the spread; the
    deviations keep them, as one process's ``F.batch_norm`` does.
    ``torch.nn.SyncBatchNorm`` would move the running variance by the
    unbiased one. Every rank must run the same train-mode passes."""

    sync_ranks = False

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.sync_ranks:
            out, mean, var = self._global_batch_norm(x)
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0., self.eps)
            if self.update_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(x.float(), dim=self._dims(x), unbiased=False)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach().to(self.running_mean), self.momentum)
                self.running_var.lerp_(var.detach().to(self.running_var), self.momentum)
                self.num_batches_tracked.add_(1)
        return out

    @staticmethod
    def _dims(x):
        return (0,) + tuple(range(2, x.dim()))

    def _global_batch_norm(self, x):
        """(normalised x, global mean, global biased variance)."""
        centred, mean, var = global_batch_moments(x.float())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        out = centred * scale.view(shape)
        if self.bias is not None:
            out = out + self.bias.view(shape)
        return out.to(x.dtype), mean, var


class BatchNorm2d(_FlaxBatchStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's running statistics (``_FlaxBatchStats``)."""


class BatchNorm3d(_FlaxBatchStats, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with Flax's running statistics (``_FlaxBatchStats``)."""


@contextlib.contextmanager
def frozen_batch_stats(net: nn.Module):
    """Within the block, the train-mode passes of ``net``'s BatchNorms keep
    their running statistics (they still normalise by the batch's, the
    global batch's under ``sync_ranks``)."""
    norms = [m for m in net.modules() if isinstance(m, _FlaxBatchStats)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag


class ChannelAttention(nn.Module):
    """Squeeze-and-excitation: the global mean of each channel through a
    1x1-conv bottleneck gates the map. BasicSR's layout (RCAN's and
    RIDNet's): ``attention`` = (pool, conv, ReLU, conv, sigmoid), so the
    convolutions are keys ``attention.1`` and ``attention.3``."""

    # the JAX module's ``squeeze`` and ``excite``, wherever the block sits
    JAX_KEY_RULES = ((r'(^|\.)squeeze\.', r'\1attention.1.'), (r'(^|\.)excite\.', r'\1attention.3.'))

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        mid = max(1, num_feat // squeeze_factor)
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(num_feat, mid, 1),
                                       nn.ReLU(), nn.Conv2d(mid, num_feat, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class CAM(nn.Module):
    """CBAM-style channel attention: one MLP (``linear_max``: Linear, ReLU,
    Linear) on the channels' max and on their mean, the two summed into a
    sigmoid gate. The reference's forward calls a ``self.linear`` that does
    not exist; the JAX package, and this, apply the ``linear_max`` MLP to
    both descriptors."""

    def __init__(self, channels: int, r: int = 2):
        super().__init__()
        self.linear_max = nn.Sequential(nn.Linear(channels, channels // r), nn.ReLU(),
                                        nn.Linear(channels // r, channels))

    def forward(self, x):
        gate = torch.sigmoid(self.linear_max(x.amax(dim=(2, 3)))
                             + self.linear_max(x.mean(dim=(2, 3))))
        return x * gate[:, :, None, None]


class CAB(nn.Module):
    """Channel-attention block: a ``ResidualBlockNoBN`` (key ``conv_block``)
    followed by ``CAM`` (key ``cam``)."""

    def __init__(self, num_feat: int, res_scale: float = 1., r: int = 2):
        super().__init__()
        self.conv_block = ResidualBlockNoBN(num_feat, res_scale)
        self.cam = CAM(num_feat, r)

    def forward(self, x):
        return self.cam(self.conv_block(x))


class Upsample(nn.Sequential):
    """Pixel-shuffle upsampler for scales 2^n and 3: (conv, PixelShuffle)
    per stage, so the convs are keys ``0``, ``2``, ... With
    ``SWIN_FUSED_CONV=1`` the convs run through ``fused_conv3x3``."""

    # the JAX module's ``conv<i>`` of an upsampler named ``upsample``
    JAX_KEY_RULES = ((r'^upsample\.conv(\d+)\.', lambda m: f'upsample.{2 * int(m.group(1))}.'),)

    def __init__(self, scale: int, num_feat: int):
        m = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                m += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        elif scale == 3:
            m += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} is not supported. Supported scales: 2^n and 3.')
        super().__init__(*m)

    def forward(self, x):
        fused = conv_fusion_enabled() and current_shard() is None
        for module in self:
            if fused and isinstance(module, nn.Conv2d):
                x = fused_conv3x3(x, module.weight, module.bias)
            elif isinstance(module, nn.Conv2d):
                x = halo_conv(module, x)
            else:
                x = module(x)
        return x


class UpsampleOneStep(nn.Sequential):
    """One conv and one pixel shuffle (the lightweight SR upsampler)."""

    def __init__(self, scale: int, num_feat: int, num_out_ch: int):
        super().__init__(nn.Conv2d(num_feat, scale**2 * num_out_ch, 3, 1, 1),
                         nn.PixelShuffle(scale))

    def forward(self, x):
        return self[1](halo_conv(self[0], x))


def resize_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsample of NCHW (each pixel repeated)."""
    return F.interpolate(x, scale_factor=scale, mode='nearest')


def resize_bicubic(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of NCHW to ``int(size * scale)``: torch's own bicubic
    (a = -0.75, border clamp, no antialiasing), which the JAX package's
    ``resize_bicubic`` reproduces."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(int(h * scale), int(w * scale)), mode='bicubic',
                         align_corners=align_corners)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C, H*s, W*s) -> (B, C*s*s, H, W), channel-major like torch's
    ``F.pixel_unshuffle``."""
    return F.pixel_unshuffle(x, scale)


def per_level(value, levels: int) -> list:
    """A per-level setting given once for all levels or as a list."""
    return list(value) if isinstance(value, (list, tuple)) else [value] * levels


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW without antialiasing, in either corner
    convention. Under a spatial scope x is a band and ``out_h`` its output
    rows, a whole multiple s of its rows (half-pixel corners only): the band
    takes one row of each neighbouring band, copies of its own edge row past
    the map's first and last row (the border clamp), is resized whole and
    cut to its own s * h rows, so that every row is the whole map's."""
    shard = current_shard()
    if shard is None:
        return F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                             align_corners=align_corners)
    h = x.shape[2]
    if align_corners or out_h % h:
        raise NotImplementedError('resize_bilinear on a band: an integer scale of the rows and '
                                  'align_corners=False only')
    s = out_h // h
    haloed = halo_rows(x, 1, 1)
    if shard.first or shard.last:
        haloed = torch.cat([x[:, :, :1] if shard.first else haloed[:, :, :1], x,
                            x[:, :, -1:] if shard.last else haloed[:, :, -1:]], 2)
    out = F.interpolate(haloed, size=((h + 2) * s, out_w), mode='bilinear', align_corners=False)
    return out[:, :, s:s + out_h]


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = 'bilinear',
              padding_mode: str = 'zeros') -> torch.Tensor:
    """Warp a map by an optical flow: output pixel (h, w) is x sampled at
    (w + dx, h + dy), in pixels.

    Args:
      x: (N, C, H, W).
      flow: (N, H, W, 2), last dimension (dx, dy).
      interpolation: 'bilinear' (the deformable sampler with one tap, a CUDA
        kernel on a card) or 'nearest' (plain indexing, no flow gradient).
      padding_mode: 'zeros' (the sampler reads the flow through its strides:
        no grid, no offset tensor), or 'border' (positions clamped to the
        map first, in PyTorch).
    """
    if padding_mode not in ('zeros', 'border'):
        raise ValueError(f'flow_warp: padding_mode {padding_mode!r} is not supported')
    n, _, h, w = x.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f'flow_warp: flow must be {(n, h, w, 2)}, got {tuple(flow.shape)}')
    if interpolation == 'bilinear' and padding_mode == 'zeros':
        return warp_by_flow(x, flow)   # the kernel reads the flow as it is
    grid_y = torch.arange(h, device=x.device, dtype=flow.dtype).view(1, h, 1)
    grid_x = torch.arange(w, device=x.device, dtype=flow.dtype).view(1, 1, w)
    sx = grid_x + flow[..., 0]
    sy = grid_y + flow[..., 1]
    if interpolation == 'bilinear':   # 'border': the clamp, with its gradient rule, in PyTorch
        return bilinear_warp(x, sy, sx, border=True)
    if interpolation != 'nearest':
        raise ValueError(f'flow_warp: interpolation {interpolation!r} is not supported')
    ix, iy = torch.round(sx).long(), torch.round(sy).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    index = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).view(n, 1, h * w)
    out = torch.gather(x.reshape(n, -1, h * w), 2, index.expand(-1, x.shape[1], -1)).view_as(x)
    if padding_mode == 'zeros':
        out = out * valid.unsqueeze(1).to(x.dtype)
    return out


def resize_flow(flow: torch.Tensor, size_type: str, sizes: Sequence[float],
                interpolation: str = 'bilinear') -> torch.Tensor:
    """Resize a flow (N, H, W, 2) to a ratio or a shape and rescale its
    values to the new pixel size."""
    n, h, w, _ = flow.shape
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f'Size type should be ratio or shape, but got type {size_type}.')
    if interpolation not in ('bilinear', 'nearest'):
        raise ValueError(f'resize_flow: interpolation {interpolation!r} is not supported')
    maps = flow.permute(0, 3, 1, 2)
    if interpolation == 'bilinear':
        resized = F.interpolate(maps, size=(out_h, out_w), mode='bilinear', align_corners=False)
    else:
        resized = F.interpolate(maps, size=(out_h, out_w), mode='nearest')
    ratio = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype, device=flow.device)
    return resized.permute(0, 2, 3, 1) * ratio
