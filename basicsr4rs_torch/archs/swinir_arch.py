"""SwinIR, the shifted-window transformer for image restoration (counterpart
of ``basicsr4rs_tpu/archs/swinir_arch.py``; reference:
basicsr/archs/swinir_arch.py).

BasicSR's module tree and key names, so a BasicSR SwinIR state_dict loads
once its ``relative_position_index`` / ``attn_mask`` buffers are dropped:
here the relative-position index and the shifted-window mask are computed
per window size and input shape, cached, and never stored. In ``eval()``
every Swin block runs as one call of ``ops.swin_block.fused_swin_block_full``
on the rolled map (one CUDA kernel for a CUDA tensor) and rolls back; a
block wider than that kernel takes (``joint_block_takes``: C or the head dim
past ``JOINT_MAX_CHANNELS`` / ``JOINT_MAX_HEAD_DIM``) runs the training
route's forward pair instead, decided by its shape before any launch; inside
a ``quantized_inference(..., swin_kernels=True)`` scope every block is the
W8A8 kernel, which takes C up to 256 and heads of up to 64 features
(``int8_block_takes``; SwinIR-L's C = 240 among them) and raises past them.
In ``train()`` it is the
differentiable pair ``fused_swin_attn_block`` + ``fused_mlp_block`` (a
forward and a backward kernel each), with the residual adds and DropPath's
per-sample scales folded into the kernels, or, with ``SWIN_JOINT_TRAIN=1``,
the joint kernel with its recomputing backward. With ``SWIN_FUSED_CONV=1`` the 3x3 convolutions after
the Swin blocks run through ``ops.conv3x3.fused_conv3x3`` with their
residual or leaky-ReLU folded in; the modules stay ``nn.Conv2d``, so the
``state_dict`` is the same on every route.

The model's own unfused forward, BasicSR's chain of LayerNorm, window
partition, ``WindowAttention.forward``, window reverse, DropPath and
LayerNorm + ``Mlp``, is the counterpart of the JAX package's XLA route, and
only the configuration selects it, as the JAX block does: ``fused_attn:
false``, or ``attn_drop_rate > 0`` in ``train()``. In training with
``drop_rate > 0`` (and no attention dropout) the attention branch stays one
kernel call with its residual not folded, followed by ``proj_drop``, the
DropPath residual and the unfused ``norm2`` / ``Mlp`` with its dropout.
Dropout is the identity in ``eval()``, so an eval forward with rates above 0
keeps the kernel routes; only ``fused_attn: false`` sends eval through the
unfused chain. Every dropout mask and DropPath scale comes from the model's
generator (``seed_drop_path``), drawn in the same order and shapes on every
route: DropPath's two scales first, then the attention dropout, then
``proj_drop`` in the windows' layout, then the MLP's two.

Under a spatial scope (``parallel/halo.py``, ``parallel: {spatial: N}``) the
network runs on a band of each image's rows, on every route above: each
convolution takes its halo rows (``arch_util.halo_conv``; under
``SWIN_FUSED_CONV=1`` too, where the band's convolution is PyTorch's, as the
JAX kernel gives way to XLA on a spatial mesh), the shifted windows' roll is
``roll_rows`` along H (the wrap-around from the first band to the last) and
``torch.roll`` along W, the shift mask is the whole map's sliced to the
band's window rows (``bias_spec = P('spatial')`` of the JAX dispatch), the
small-input rule reads the whole map's height and ``ape``'s embedding is cut
to the band's tokens. A band must hold whole window rows. Dropout has no
spatial route: a network with ``drop_rate`` or ``attn_drop_rate`` above 0
declares none (``SPATIAL_SHARDING``).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv_fusion_enabled, fused_conv3x3
from ..ops.mlp_block import fused_mlp_block
from ..ops.quant import swin_kernels_int8
from ..ops.swin_block import (fused_swin_attn_block, fused_swin_block_full,
                              joint_block_takes, joint_train_enabled, swin_block_full_int8)
from ..ops.window_attention import fused_window_attention
from ..parallel.halo import current_shard, roll_rows
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Upsample, UpsampleOneStep, default_conv_init_, halo_conv, trunc_normal_


def conv3x3(conv: nn.Conv2d, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
            act_slope: Optional[float] = None) -> torch.Tensor:
    """``conv(x)`` (+ ``residual``), then a leaky-ReLU of ``act_slope`` when
    given: one call of ``fused_conv3x3`` on the module's parameters when
    ``SWIN_FUSED_CONV=1``, else (and on a band) the module and plain tensor
    code."""
    if conv_fusion_enabled() and current_shard() is None:
        return fused_conv3x3(x, conv.weight, conv.bias, residual, act_slope)
    out = halo_conv(conv, x)
    if residual is not None:
        out = out + residual
    if act_slope is not None:
        out = F.leaky_relu(out, act_slope)
    return out


def _real_tensor_cache(maxsize: int):
    """A cache of at most ``maxsize`` results (the oldest out first) for a
    function of hashable arguments that makes a constant tensor, keeping
    only real tensors: traced by ``torch.export`` the function makes a fake
    tensor, which is handed back and never kept, so that no later forward
    meets it. ``.cache`` is the {arguments: tensor} store, ``.cache_clear()``
    empties it."""
    def decorate(make):
        cache = {}

        @functools.wraps(make)
        def cached(*key):
            t = cache.get(key)
            if t is None:
                t = make(*key)
                if type(t) is torch.Tensor:
                    if len(cache) >= maxsize:
                        cache.pop(next(iter(cache)), None)
                    cache[key] = t
            return t
        cached.cache, cached.cache_clear = cache, cache.clear
        return cached
    return decorate


@_real_tensor_cache(maxsize=16)
def _relative_position_index(window_size: int, table_window: int,
                             device: torch.device) -> torch.Tensor:
    """(n*n,) row of the (2*table_window-1)^2 bias table for each query/key
    pair of a window_size x window_size window (reference
    swinir_arch.py:119-133)."""
    coords = np.stack(np.meshgrid(np.arange(window_size), np.arange(window_size),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (table_window - 1)
    index = rel[:, :, 0] * (2 * table_window - 1) + rel[:, :, 1]
    # cached across calls: made outside inference mode, so that a training
    # forward after a validation can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(index.reshape(-1)).to(device)


@_real_tensor_cache(maxsize=64)
def _shift_attn_mask(h: int, w: int, window_size: int, shift_size: int,
                     device: torch.device) -> torch.Tensor:
    """(nW, n, n) float32 0/-100 mask of the shifted windows of an h x w map
    (reference swinir_arch.py:226-244 calculate_mask)."""
    img_mask = np.zeros((h, w), np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size), slice(-shift_size, None))
    for i, (rows, cols) in enumerate(itertools.product(slices, slices)):
        img_mask[rows, cols] = i
    m = img_mask.reshape(h // window_size, window_size, w // window_size, window_size)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    with torch.inference_mode(False):   # cached: see _relative_position_index
        return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


def shift_mask(h: int, w: int, window_size: int, shift_size: int,
               device: torch.device) -> torch.Tensor:
    """``_shift_attn_mask`` of an h x w map, or under a spatial scope (h a
    band's rows) the whole map's mask cut to the band's window rows."""
    shard = current_shard()
    if shard is None:
        return _shift_attn_mask(h, w, window_size, shift_size, device)
    whole = _shift_attn_mask(shard.global_rows(h), w, window_size, shift_size, device)
    per_band = (h // window_size) * (w // window_size)
    return whole.narrow(0, shard.index * per_band, per_band)


def roll_map(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x (B, H, W, C) rolled by ``shift`` along H and W; H is the whole map's
    under a spatial scope (``roll_rows``)."""
    if current_shard() is None:
        return torch.roll(x, (shift, shift), dims=(1, 2))
    return torch.roll(roll_rows(x, shift, dim=1), shift, dims=2)


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws, ws, C) (reference swinir_arch.py:60-72)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition`` (reference swinir_arch.py:75-92)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _draw_keep(shape, keep: float, device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """A float32 mask of 0 and 1 / keep on ``device``, each entry kept with
    probability ``keep``, drawn from ``generator`` (torch's global one on
    ``device`` when None)."""
    draw_on = device if generator is None else generator.device
    mask = torch.rand(shape, device=draw_on, generator=generator) < keep
    return mask.to(device=device, dtype=torch.float32) / keep


class Dropout(nn.Module):
    """Inverted dropout at rate ``p`` in ``train()``, the identity in
    ``eval()``; the mask comes from ``generator`` (set by
    ``SwinIR.seed_drop_path``; torch's global one when None)."""

    def __init__(self, p: float = 0.):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        return self.training and self.p > 0.

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return x
        return x * _draw_keep(x.shape, 1. - self.p, x.device, self.generator).to(x.dtype)


def drop_path(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """DropPath of x (B, ...) with its per-sample scales (B,) float32 (0 or
    1 / keep), or x itself when ``scale`` is None."""
    if scale is None:
        return x
    return x * scale.to(x.dtype).view(-1, *(1,) * (x.dim() - 1))


class WindowAttention(nn.Module):
    """Window attention with relative-position bias (reference
    swinir_arch.py:95-192). ``forward`` is BasicSR's chain on windowed
    tokens; SwinIR's kernel routes hand the parameters to the block kernels;
    ``fused`` is the attention on its own, for blocks that normalise
    otherwise (the diffusion UNet's)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0., proj_drop: float = 0.):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads)**-0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1)**2, num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def relative_position_bias(self, window_size: int) -> torch.Tensor:
        """(heads, n, n) float32 bias of a window_size x window_size window."""
        n = window_size * window_size
        index = _relative_position_index(window_size, self.window_size,
                                         self.relative_position_bias_table.device)
        table = self.relative_position_bias_table[index]
        return table.view(n, n, -1).permute(2, 0, 1).float().contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B*nW, n, C) tokens of square windows, n = ws * ws; ``mask``:
        (nW, n, n) shift mask or None. qkv, scaled q k^T, relative bias,
        mask, softmax, ``attn_drop``, times v, proj, ``proj_drop``."""
        b_, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = attn + self.relative_position_bias(math.isqrt(n))[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, heads, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.view(-1, heads, n, n)
        attn = self.attn_drop(torch.softmax(attn, dim=-1))
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj_drop(self.proj(x))

    def fused(self, x: torch.Tensor, window_size: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """proj(W-MSA(qkv(x))) for x (B, H, W, C), already rolled: the two
        GEMMs as ``nn.Linear``, the attention between them as one call of
        ``fused_window_attention``. ``mask``: (nW, n, n) shift mask or None;
        the bias handed on is (1, heads, n, n) without it and
        (nW, heads, n, n) with it."""
        bias = self.relative_position_bias(window_size)[None]
        if mask is not None:
            bias = bias + mask.float()[:, None]
        out = fused_window_attention(self.qkv(x), bias, window_size, self.num_heads, self.scale)
        return self.proj(out)

    def windowed(self, x: torch.Tensor, window_size: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``forward`` on the windows of x (B, H, W, C), already rolled, put
        back in place: (B, H, W, C)."""
        _, h, w, c = x.shape
        windows = window_partition(x, window_size).reshape(-1, window_size * window_size, c)
        out = self(windows, mask)
        return window_reverse(out.view(-1, window_size, window_size, c), window_size, h, w)


class Mlp(nn.Module):
    """fc1, GELU (exact), dropout, fc2, dropout (reference swinir_arch.py:22-41)."""

    def __init__(self, in_features: int, hidden_features: int, drop: float = 0.):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class SwinTransformerBlock(nn.Module):
    """(reference swinir_arch.py:194-310). Its route, by the rule of the JAX
    block: the unfused chain when ``fused_attn`` is off, or in ``train()``
    with attention dropout; in ``train()`` with ``drop > 0``, the attention
    branch's kernel without its residual, then the unfused rest; else the
    kernel routes (see the module docstring)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4., qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0., drop: float = 0., attn_drop: float = 0.,
                 fused_attn: bool = True):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        self.fused_attn = fused_attn
        # DropPath draws from this generator (torch's global one when None);
        # SwinIR hands every block the model's
        self.generator: Optional[torch.Generator] = None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale, attn_drop,
                                    drop)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def drop_path_scales(self, batch: int, device: torch.device):
        """DropPath's per-sample scales (s1, s2) = bernoulli(keep) / keep, each
        (batch,) float32, for the attention and the MLP branch; None when
        the block keeps every path (``drop_path == 0`` or ``eval()``)."""
        if not self.training or self.drop_path == 0.:
            return None
        return _draw_keep((2, batch), 1. - self.drop_path, device, self.generator).unbind(0)

    def forward(self, x: torch.Tensor, x_size, residual_scales=None) -> torch.Tensor:
        """x: (B, H*W, C) tokens of an H x W map. ``residual_scales``
        overrides the DropPath draw of a training forward with given (s1, s2)."""
        h, w = x_size
        b, _, c = x.shape
        window_size, shift_size = self.window_size, self.shift_size
        shard = current_shard()
        map_h = h if shard is None else shard.global_rows(h)
        if min(map_h, w) <= window_size:  # small input: shrink the window, no shift
            window_size, shift_size = min(map_h, w), 0
        if shard is not None and h % window_size:
            raise ValueError(f'SwinIR on a band: {h} rows are not whole rows of {window_size}-row '
                             'windows (H / spatial must be a multiple of the window)')
        if self.training and residual_scales is None:
            residual_scales = self.drop_path_scales(b, x.device)
        s1, s2 = residual_scales if residual_scales is not None else (None, None)
        attn = self.attn
        unfused = not self.fused_attn or attn.attn_drop.active()

        shortcut = x
        if unfused:   # LayerNorm is per token: before the roll, as the reference
            x = self.norm1(x)
        x = x.reshape(b, h, w, c)
        mask = None
        if shift_size > 0:
            x = roll_map(x, -shift_size)
            mask = shift_mask(h, w, window_size, shift_size, x.device)
        if unfused:
            return self._unfused_rest(attn.windowed(x, window_size, mask), shortcut, x_size,
                                      shift_size, s1, s2)
        qkv_bias = attn.qkv.bias
        if qkv_bias is None:
            qkv_bias = torch.zeros(3 * c, device=x.device)
        attn_args = (self.norm1.weight, self.norm1.bias, attn.qkv.weight, qkv_bias,
                     attn.proj.weight, attn.proj.bias, attn.relative_position_bias(window_size),
                     mask)
        mlp_args = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                    self.mlp.fc2.weight, self.mlp.fc2.bias)
        geometry = (window_size, attn.num_heads, attn.scale)
        if self.training and self.mlp.drop.active():
            # the branch alone from its kernel; proj_drop on its windows, as
            # the unfused route draws it
            x = fused_swin_attn_block(x.contiguous(), *attn_args, *geometry)
            x = window_reverse(attn.proj_drop(window_partition(x, window_size)),
                               window_size, h, w)
            return self._unfused_rest(x, shortcut, x_size, shift_size, s1, s2)
        if self.training and joint_train_enabled():
            x = fused_swin_block_full(x.contiguous(), *attn_args, *mlp_args, *geometry,
                                      residual_scales=residual_scales)
        elif self.training:
            # the split pair; the residual adds (and DropPath's x + s * branch)
            # happen inside the kernels, and the roll back commutes with both
            x = fused_swin_attn_block(x.contiguous(), *attn_args, *geometry,
                                      add_residual=s1 is None, residual_scale=s1)
            x = fused_mlp_block(x, *mlp_args, add_residual=s2 is None, residual_scale=s2)
        elif swin_kernels_int8():
            x = swin_block_full_int8(x.contiguous(), *attn_args, *mlp_args, *geometry)
        elif joint_block_takes(c, attn.num_heads):
            x = fused_swin_block_full(x.contiguous(), *attn_args, *mlp_args, *geometry)
        else:   # wider than the joint kernel: the training route's forward pair
            x = fused_swin_attn_block(x.contiguous(), *attn_args, *geometry, add_residual=True)
            x = fused_mlp_block(x, *mlp_args, add_residual=True)
        if shift_size > 0:
            x = roll_map(x, shift_size)
        return x.reshape(b, h * w, c)

    def _unfused_rest(self, x, shortcut, x_size, shift_size, s1, s2):
        """From the rolled attention branch x (B, H, W, C): roll back,
        ``shortcut + DropPath(x)``, then ``+ DropPath(Mlp(norm2(.)))``."""
        h, w = x_size
        if shift_size > 0:
            x = roll_map(x, shift_size)
        x = shortcut + drop_path(x.reshape(shortcut.shape), s1)
        return x + drop_path(self.mlp(self.norm2(x)), s2)


class BasicLayer(nn.Module):
    """A stack of Swin blocks, shifted every other one (reference
    swinir_arch.py:393-477)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop_path: Sequence[float], drop: float = 0., attn_drop: float = 0.,
                 fused_attn: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                 qk_scale, drop_path[i], drop, attn_drop, fused_attn)
            for i in range(depth)])

    def forward(self, x, x_size):
        for block in self.blocks:
            x = block(x, x_size)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block: Swin blocks, a convolution, a residual
    (reference swinir_arch.py:480-569). ``resi_connection``: ``1conv``, one
    3x3 convolution; ``3conv``, 3x3 C -> C/4, leaky-ReLU 0.2, 1x1, leaky-ReLU
    0.2, 3x3 C/4 -> C (keys ``conv.0``, ``conv.2``, ``conv.4``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop_path: Sequence[float], resi_connection: str = '1conv', drop: float = 0.,
                 attn_drop: float = 0., fused_attn: bool = True):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size, mlp_ratio,
                                         qkv_bias, qk_scale, drop_path, drop, attn_drop,
                                         fused_attn)
        if resi_connection == '1conv':
            self.conv = nn.Conv2d(dim, dim, 3, 1, 1)
        elif resi_connection == '3conv':
            self.conv = nn.Sequential(
                nn.Conv2d(dim, dim // 4, 3, 1, 1), nn.LeakyReLU(negative_slope=0.2, inplace=True),
                nn.Conv2d(dim // 4, dim // 4, 1, 1, 0),
                nn.LeakyReLU(negative_slope=0.2, inplace=True), nn.Conv2d(dim // 4, dim, 3, 1, 1))
        else:
            raise ValueError(f'unknown resi_connection {resi_connection!r}')

    def forward(self, x, x_size):
        res = self.residual_group(x, x_size)
        b, _, c = res.shape
        img = res.transpose(1, 2).reshape(b, c, *x_size)
        if isinstance(self.conv, nn.Sequential):
            for module in self.conv:
                img = halo_conv(module, img) if isinstance(module, nn.Conv2d) else module(img)
            return img.flatten(2).transpose(1, 2) + x
        if conv_fusion_enabled():   # the conv and the RSTB residual in one call
            shortcut = x.transpose(1, 2).reshape(b, c, *x_size)
            return conv3x3(self.conv, img, residual=shortcut).flatten(2).transpose(1, 2)
        return halo_conv(self.conv, img).flatten(2).transpose(1, 2) + x


class PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (key ``patch_embed.norm``)."""

    def __init__(self, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim) if patch_norm else None


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """(reference swinir_arch.py:694-956). Upsamplers: ``pixelshuffle``
    (classical SR), ``pixelshuffledirect`` (lightweight SR), ``nearest+conv``
    (real-world SR, x4) and ``''`` (denoising / JPEG artifacts).
    ``resi_connection``: ``1conv`` or ``3conv`` (see ``RSTB``). ``ape`` adds
    BasicSR's absolute position embedding, (1, (img_size // patch_size)**2,
    embed_dim): the input's token count must be that (``patch_size`` changes
    nothing else, as BasicSR's ``PatchEmbed`` only flattens). ``drop_rate``
    drops after the patch embedding and in every block's projection and MLP,
    ``attn_drop_rate`` the attention weights; ``fused_attn: false`` runs
    every block's unfused chain (see the module docstring). ``generator``
    seeds the parameter init (torch's global generator when None).
    ``drop_path_rate`` is the stochastic-depth rate of the last block,
    rising linearly from 0 at the first; a training forward draws the
    DropPath and dropout masks from ``drop_path_generator`` (see
    ``seed_drop_path``)."""

    # JAX package parameter path -> BasicSR key (utils/jax_convert.py); the
    # 3conv layers' conv_0 / conv_2 / conv_4 become conv.0 / .2 / .4 by the
    # module-list rule
    JAX_KEY_RULES = (
        (r'^patch_embed_norm\.', 'patch_embed.norm.'),
        (r'^upsample\.conv(\d+)\.', lambda m: f'upsample.{2 * int(m.group(1))}.'),
    )

    def __init__(self, img_size: int = 64, patch_size: int = 1, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6), window_size: int = 7,
                 mlp_ratio: float = 4., qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0., attn_drop_rate: float = 0., drop_path_rate: float = 0.1,
                 ape: bool = False, patch_norm: bool = True, upscale: int = 2,
                 img_range: float = 1., upsampler: str = '', resi_connection: str = '1conv',
                 fused_attn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        num_feat = 64
        self.img_range = img_range
        self.upscale = upscale
        self.upsampler = upsampler
        mean = (0.4488, 0.4371, 0.4040) if in_chans == 3 else (0.,)
        self.register_buffer('mean', torch.tensor(mean).view(1, -1, 1, 1), persistent=False)

        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        if ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, (img_size // patch_size)**2, embed_dim))
        else:
            self.absolute_pos_embed = None
        self.pos_drop = Dropout(drop_rate)
        # stochastic depth decay rule (reference swinir_arch.py:786)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias, qk_scale,
                 dpr[sum(depths[:i]):sum(depths[:i + 1])], resi_connection, drop_rate,
                 attn_drop_rate, fused_attn)
            for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)

        if upsampler in ('pixelshuffle', 'nearest+conv'):
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(inplace=True))
        if upsampler == 'pixelshuffle':
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == 'pixelshuffledirect':
            self.upsample = UpsampleOneStep(upscale, embed_dim, in_chans)
        elif upsampler == 'nearest+conv':
            if upscale != 4:
                raise ValueError('nearest+conv supports x4 only')
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
            self.lrelu = nn.LeakyReLU(negative_slope=0.2, inplace=True)
        elif upsampler == '':
            self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, 1, 1)
        else:
            raise ValueError(f'unknown upsampler {upsampler!r}')
        self.reset_parameters(generator)
        self.drop_path_generator: Optional[torch.Generator] = None
        self.dropout = drop_rate > 0 or attn_drop_rate > 0

    @property
    def SPATIAL_SHARDING(self) -> bool:   # noqa: N802  the flag the models read
        """Whether this network runs on bands of rows (no dropout)."""
        return not self.dropout

    def seed_drop_path(self, seed: int, device='cpu') -> torch.Generator:
        """Give the model its own generator of DropPath and dropout masks on
        ``device``, seeded."""
        self.drop_path_generator = torch.Generator(device=device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (SwinTransformerBlock, Dropout)):
                m.generator = self.drop_path_generator
        return self.drop_path_generator

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """BasicSR's init: Linear weights and the bias tables trunc-normal
        (std .02), Linear biases 0, LayerNorm 1/0, convs torch's default."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, .02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                default_conv_init_(m, generator)
            elif isinstance(m, WindowAttention):
                trunc_normal_(m.relative_position_bias_table, .02, generator)
        if self.absolute_pos_embed is not None:
            trunc_normal_(self.absolute_pos_embed, .02, generator)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        if self.absolute_pos_embed is not None:
            shard = current_shard()
            bands = 1 if shard is None else shard.size
            if x.shape[1] * bands != self.absolute_pos_embed.shape[1]:
                raise ValueError(f'SwinIR with ape: {h * bands}x{w} is {x.shape[1] * bands} '
                                 'tokens, the position embedding holds '
                                 f'{self.absolute_pos_embed.shape[1]}')
            pos = self.absolute_pos_embed
            if shard is not None:   # the band's tokens
                pos = pos.narrow(1, shard.index * x.shape[1], x.shape[1])
            x = x + pos
        x = self.pos_drop(x)
        for layer in self.layers:
            x = layer(x, (h, w))
        return self.norm(x).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) with H, W multiples of the window (or at most one
        window); returns (B, C, upscale*H, upscale*W)."""
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler == '':
            x_first = halo_conv(self.conv_first, x)
            res = conv3x3(self.conv_after_body, self.forward_features(x_first), x_first)
            x = x + halo_conv(self.conv_last, res)
        else:
            x = halo_conv(self.conv_first, x)
            x = conv3x3(self.conv_after_body, self.forward_features(x), x)
            if self.upsampler == 'pixelshuffledirect':
                x = self.upsample(x)
            else:
                x = conv3x3(self.conv_before_upsample[0], x, act_slope=0.01)
            if self.upsampler == 'pixelshuffle':
                x = halo_conv(self.conv_last, self.upsample(x))
            elif self.upsampler == 'nearest+conv':
                x = conv3x3(self.conv_up1, F.interpolate(x, scale_factor=2, mode='nearest'),
                            act_slope=0.2)
                x = conv3x3(self.conv_up2, F.interpolate(x, scale_factor=2, mode='nearest'),
                            act_slope=0.2)
                x = halo_conv(self.conv_last, conv3x3(self.conv_hr, x, act_slope=0.2))
        return x / self.img_range + mean
