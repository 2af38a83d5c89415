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
W8A8 kernel, which raises past those widths. In ``train()`` it is the
differentiable pair ``fused_swin_attn_block`` + ``fused_mlp_block`` (a
forward and a backward kernel each), with the residual adds and DropPath's
per-sample scales folded into the kernels, or, with ``SWIN_JOINT_TRAIN=1``,
the joint kernel with its recomputing backward. With ``SWIN_FUSED_CONV=1`` the 3x3 convolutions after
the Swin blocks run through ``ops.conv3x3.fused_conv3x3`` with their
residual or leaky-ReLU folded in; the modules stay ``nn.Conv2d``, so the
``state_dict`` is the same on every route.
"""

from __future__ import annotations

import functools
import itertools
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
from ..utils.registry import ARCH_REGISTRY
from .arch_util import Upsample, UpsampleOneStep, default_conv_init_, trunc_normal_


def conv3x3(conv: nn.Conv2d, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
            act_slope: Optional[float] = None) -> torch.Tensor:
    """``conv(x)`` (+ ``residual``), then a leaky-ReLU of ``act_slope`` when
    given: one call of ``fused_conv3x3`` on the module's parameters when
    ``SWIN_FUSED_CONV=1``, else the module and plain tensor code."""
    if conv_fusion_enabled():
        return fused_conv3x3(x, conv.weight, conv.bias, residual, act_slope)
    out = conv(x)
    if residual is not None:
        out = out + residual
    if act_slope is not None:
        out = F.leaky_relu(out, act_slope)
    return out


@functools.lru_cache(maxsize=16)
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


@functools.lru_cache(maxsize=64)
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


class WindowAttention(nn.Module):
    """Parameters of window attention with relative-position bias (reference
    swinir_arch.py:95-192). SwinIR's blocks hand them to the block kernels;
    ``fused`` is the attention on its own, for blocks that normalise
    otherwise (the diffusion UNet's)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads)**-0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1)**2, num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def relative_position_bias(self, window_size: int) -> torch.Tensor:
        """(heads, n, n) float32 bias of a window_size x window_size window."""
        n = window_size * window_size
        index = _relative_position_index(window_size, self.window_size,
                                         self.relative_position_bias_table.device)
        table = self.relative_position_bias_table[index]
        return table.view(n, n, -1).permute(2, 0, 1).float().contiguous()

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


class Mlp(nn.Module):

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)


class SwinTransformerBlock(nn.Module):
    """(reference swinir_arch.py:194-310)"""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4., qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        # DropPath draws from this generator (torch's global one when None);
        # SwinIR hands every block the model's
        self.generator: Optional[torch.Generator] = None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def drop_path_scales(self, batch: int, device: torch.device):
        """DropPath's per-sample scales (s1, s2) = bernoulli(keep) / keep, each
        (batch,) float32, for the attention and the MLP branch; None when
        the block keeps every path (``drop_path == 0`` or ``eval()``)."""
        if not self.training or self.drop_path == 0.:
            return None
        keep = 1. - self.drop_path
        generator = self.generator
        draw_on = device if generator is None else generator.device
        mask = torch.rand(2, batch, device=draw_on, generator=generator) < keep
        s1, s2 = (mask.to(device=device, dtype=torch.float32) / keep).unbind(0)
        return s1, s2

    def forward(self, x: torch.Tensor, x_size, residual_scales=None) -> torch.Tensor:
        """x: (B, H*W, C) tokens of an H x W map. ``residual_scales``
        overrides the DropPath draw of a training forward with given (s1, s2)."""
        h, w = x_size
        b, _, c = x.shape
        window_size, shift_size = self.window_size, self.shift_size
        if min(x_size) <= window_size:  # small input: shrink the window, no shift
            window_size, shift_size = min(x_size), 0

        x = x.reshape(b, h, w, c)
        mask = None
        if shift_size > 0:
            x = torch.roll(x, (-shift_size, -shift_size), dims=(1, 2))
            mask = _shift_attn_mask(h, w, window_size, shift_size, x.device)
        attn = self.attn
        qkv_bias = attn.qkv.bias
        if qkv_bias is None:
            qkv_bias = torch.zeros(3 * c, device=x.device)
        attn_args = (self.norm1.weight, self.norm1.bias, attn.qkv.weight, qkv_bias,
                     attn.proj.weight, attn.proj.bias, attn.relative_position_bias(window_size),
                     mask)
        mlp_args = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                    self.mlp.fc2.weight, self.mlp.fc2.bias)
        geometry = (window_size, attn.num_heads, attn.scale)
        if self.training:
            if residual_scales is None:
                residual_scales = self.drop_path_scales(b, x.device)
        if self.training and joint_train_enabled():
            x = fused_swin_block_full(x.contiguous(), *attn_args, *mlp_args, *geometry,
                                      residual_scales=residual_scales)
        elif self.training:
            # the split pair; the residual adds (and DropPath's x + s * branch)
            # happen inside the kernels, and the roll back commutes with both
            s1, s2 = residual_scales if residual_scales is not None else (None, None)
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
            x = torch.roll(x, (shift_size, shift_size), dims=(1, 2))
        return x.reshape(b, h * w, c)


class BasicLayer(nn.Module):
    """A stack of Swin blocks, shifted every other one (reference
    swinir_arch.py:393-477)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop_path: Sequence[float]):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                                 qkv_bias, qk_scale, drop_path[i]) for i in range(depth)])

    def forward(self, x, x_size):
        for block in self.blocks:
            x = block(x, x_size)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block: Swin blocks, a 3x3 conv, a residual
    (reference swinir_arch.py:480-569)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop_path: Sequence[float]):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size, mlp_ratio,
                                         qkv_bias, qk_scale, drop_path)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, x_size):
        res = self.residual_group(x, x_size)
        b, _, c = res.shape
        img = res.transpose(1, 2).reshape(b, c, *x_size)
        if conv_fusion_enabled():   # the conv and the RSTB residual in one call
            shortcut = x.transpose(1, 2).reshape(b, c, *x_size)
            return conv3x3(self.conv, img, residual=shortcut).flatten(2).transpose(1, 2)
        return self.conv(img).flatten(2).transpose(1, 2) + x


class PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (key ``patch_embed.norm``)."""

    def __init__(self, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim) if patch_norm else None


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """(reference swinir_arch.py:694-956). Upsamplers: ``pixelshuffle``
    (classical SR), ``pixelshuffledirect`` (lightweight SR), ``nearest+conv``
    (real-world SR, x4) and ``''`` (denoising / JPEG artifacts). Only the
    ``1conv`` residual connection and no absolute position embedding are
    ported. ``generator`` seeds the parameter init (torch's global generator
    when None). ``drop_path_rate`` is the stochastic-depth rate of the last
    block, rising linearly from 0 at the first; a training forward draws the
    DropPath masks from ``drop_path_generator`` (see ``seed_drop_path``)."""

    # JAX package parameter path -> BasicSR key (utils/jax_convert.py)
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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if patch_size != 1 or ape or resi_connection != '1conv':
            raise NotImplementedError('SwinIR: patch_size 1, ape False and resi_connection '
                                      '1conv are ported')
        if drop_rate != 0. or attn_drop_rate != 0.:
            raise NotImplementedError('SwinIR: drop_rate and attn_drop_rate other than 0 need '
                                      'the unfused block, which is not ported')
        num_feat = 64
        self.img_range = img_range
        self.upscale = upscale
        self.upsampler = upsampler
        mean = (0.4488, 0.4371, 0.4040) if in_chans == 3 else (0.,)
        self.register_buffer('mean', torch.tensor(mean).view(1, -1, 1, 1), persistent=False)

        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        # stochastic depth decay rule (reference swinir_arch.py:786)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias, qk_scale,
                 dpr[sum(depths[:i]):sum(depths[:i + 1])])
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

    def seed_drop_path(self, seed: int, device='cpu') -> torch.Generator:
        """Give the model its own DropPath generator on ``device``, seeded."""
        self.drop_path_generator = torch.Generator(device=device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, SwinTransformerBlock):
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

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        for layer in self.layers:
            x = layer(x, (h, w))
        return self.norm(x).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) with H, W multiples of the window (or at most one
        window); returns (B, C, upscale*H, upscale*W)."""
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler == '':
            x_first = self.conv_first(x)
            res = conv3x3(self.conv_after_body, self.forward_features(x_first), x_first)
            x = x + self.conv_last(res)
        else:
            x = self.conv_first(x)
            x = conv3x3(self.conv_after_body, self.forward_features(x), x)
            if self.upsampler == 'pixelshuffledirect':
                x = self.upsample(x)
            else:
                x = conv3x3(self.conv_before_upsample[0], x, act_slope=0.01)
            if self.upsampler == 'pixelshuffle':
                x = self.conv_last(self.upsample(x))
            elif self.upsampler == 'nearest+conv':
                x = conv3x3(self.conv_up1, F.interpolate(x, scale_factor=2, mode='nearest'),
                            act_slope=0.2)
                x = conv3x3(self.conv_up2, F.interpolate(x, scale_factor=2, mode='nearest'),
                            act_slope=0.2)
                x = self.conv_last(conv3x3(self.conv_hr, x, act_slope=0.2))
        return x / self.img_range + mean
