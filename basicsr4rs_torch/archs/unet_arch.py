"""ResShift denoiser UNets (counterpart of
``basicsr4rs_tpu/archs/unet_arch.py``; reference: basicsr/archs/unet_arch.py
and archs/resshift/swin_transformer.py).

ADM-style UNets with a timestep embedding. ``UNetModelSwin``'s attention
stages are Swin layers with GroupNorm (``BasicLayer`` of ``SwinBlockGN``),
``UNetModel``'s are global attention blocks, ``UNetModelConv`` has neither
attention nor norms. ``cond_lq`` concatenates the LQ (through a small feature
extractor when it is larger than the latent, resized when needed) to the
input. NCHW, BasicSR's module tree and key names
(``input_blocks.N.M``, ``mlp.fc1`` as a 1x1 ``Conv2d``, ``patch_embed.proj``).

Every ``SwinBlockGN`` runs its attention as qkv ``Linear`` -> one call of
``ops.window_attention.fused_window_attention`` on the rolled (B, H, W, 3C)
map (one CUDA kernel forward, one backward, for a CUDA tensor) -> proj
``Linear``; with ``fused_attn: false`` it runs SwinIR's unfused
``WindowAttention.forward`` on the map's windows instead, the counterpart of
the JAX package's XLA route. A torch module is built before it sees an input, so the
constructors take ``lq_channels`` (default ``in_channels``) where the JAX
modules read the channel count off the first batch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import (default_conv_init_, per_level, pixel_unshuffle, resize_bicubic,
                        resize_nearest, trunc_normal_)
from .swinir_arch import WindowAttention


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal embeddings (B, dim) of the (B,) timesteps: cos | sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) / half
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device))
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-5)


def shift_attn_mask_resshift(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """(nW, n, n) float32 0/-100 shift mask with the two quirks of the
    reference (archs/resshift/swin_transformer.py:213-236) that trained
    checkpoints depend on: the region ids vary along H only (6, 7, 8: the
    reference slices a (1, 1, H, W) map as if it were NHWC, so only the last
    row assignment lands), and the mask's tokens are flattened w-major,
    transposed against the data windows."""
    rows = np.zeros((h,), np.float32)
    rows[0:h - window_size] = 6
    rows[h - window_size:h - shift_size] = 7
    rows[h - shift_size:] = 8
    img = np.broadcast_to(rows[:, None], (h, w)).copy()
    m = img.reshape(1, h // window_size, window_size, w // window_size, window_size)
    m = m.transpose(0, 1, 3, 4, 2).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _shift_mask_tensor(h: int, w: int, window_size: int, shift_size: int,
                       device: torch.device) -> torch.Tensor:
    # cached across forwards: made outside inference mode, so that a training
    # forward after a validation can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(shift_attn_mask_resshift(h, w, window_size, shift_size)).to(device)


class ADMUpsample(nn.Module):
    """Nearest x2, then an optional 3x3 conv (key ``conv``)."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        if use_conv:
            self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)
        self.use_conv = use_conv

    def forward(self, x):
        x = resize_nearest(x, 2)
        return self.conv(x) if self.use_conv else x


class ADMDownsample(nn.Module):
    """Stride-2 3x3 conv (key ``op``) or 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        if use_conv:
            self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)
        self.use_conv = use_conv

    def forward(self, x):
        return self.op(x) if self.use_conv else F.avg_pool2d(x, 2)


def _zero(module: nn.Module) -> nn.Module:
    module.zero_init = True   # reset_parameters zeroes its weight and bias
    return module


def _resample(h, x, up: bool, down: bool):
    if up:
        return resize_nearest(h, 2), resize_nearest(x, 2)
    if down:
        return F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
    return h, x


def _skip(channels: int, out_ch: int, use_conv: bool) -> nn.Module:
    if out_ch == channels:
        return nn.Identity()
    return nn.Conv2d(channels, out_ch, 3, padding=1) if use_conv else nn.Conv2d(channels, out_ch, 1)


class ResBlock(nn.Module):
    """ADM residual block: GroupNorm-SiLU-conv, the timestep embedding added
    or, with ``use_scale_shift_norm``, applied as scale and shift after the
    second norm, SiLU-dropout-conv (zero-initialised), skip."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.,
                 out_channels: Optional[int] = None, use_conv: bool = False,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(group_norm(channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(group_norm(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                        _zero(nn.Conv2d(out_ch, out_ch, 3, padding=1)))
        self.skip_connection = _skip(channels, out_ch, use_conv)

    def forward(self, x, emb):
        h = self.in_layers[1](self.in_layers[0](x))
        h, x = _resample(h, x, self.up, self.down)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[1:](h)
        else:
            h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class ResBlockConv(nn.Module):
    """Norm-free residual block: SiLU-conv, the embedding added or applied as
    scale and shift straight on the features, SiLU-conv (zero-initialised)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = False, use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(nn.SiLU(), nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(nn.SiLU(), _zero(nn.Conv2d(out_ch, out_ch, 3, padding=1)))
        self.skip_connection = _skip(channels, out_ch, use_conv)

    def forward(self, x, emb):
        h, x = _resample(self.in_layers[0](x), x, self.up, self.down)
        h = self.in_layers[1](h)
        emb_out = self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = h * (1 + scale) + shift
        else:
            h = h + emb_out
        return self.skip_connection(x) + self.out_layers(h)


class AttentionBlock(nn.Module):
    """Global self-attention over all H*W positions: GroupNorm, a 1x1
    ``Conv1d`` to q|k|v (channels split as (3, heads, head_dim), the JAX
    package's order), softmax(q k^T / sqrt(head_dim)) v, a zero-initialised
    ``proj_out``, residual."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.num_heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.norm = group_norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = _zero(nn.Conv1d(channels, channels, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        heads = self.num_heads
        qkv = self.qkv(self.norm(x).reshape(b, c, h * w))
        q, k, v = qkv.reshape(b, 3, heads, c // heads, h * w).unbind(1)
        scale = 1 / math.sqrt(math.sqrt(c // heads))
        attn = torch.softmax(torch.einsum('bhcq,bhck->bhqk', q * scale, k * scale), dim=-1)
        out = torch.einsum('bhqk,bhck->bhcq', attn, v).reshape(b, c, h * w)
        return x + self.proj_out(out).reshape(b, c, h, w)


class ConvMlp(nn.Module):
    """fc1 -> GELU (exact) -> fc2, both 1x1 convs (keys ``fc1``, ``fc2``)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Conv2d(in_features, hidden_features, 1)
        self.act = nn.GELU()
        self.fc2 = nn.Conv2d(hidden_features, in_features, 1)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SwinBlockGN(nn.Module):
    """Swin block with GroupNorm (the ResShift flavour): x + W-MSA(GN(x)),
    then + MLP(GN(.)). An input no larger than the window shrinks the window
    to it and drops the shift, per input, as the JAX package does; the
    relative-position table keeps the configured window's size and is
    indexed with the smaller window's offsets. ``fused_attn``: the attention
    as the window-attention kernel (default), or partitioned into windows
    and run through ``WindowAttention.forward``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 2., fused_attn: bool = True):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.fused_attn = fused_attn
        self.norm1 = group_norm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = group_norm(dim)
        self.mlp = ConvMlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        _, _, h, w = x.shape
        window_size, shift_size = self.window_size, self.shift_size
        if min(h, w) <= window_size:
            window_size, shift_size = min(h, w), 0
        xn = self.norm1(x).permute(0, 2, 3, 1)   # (B, H, W, C) for the roll and the attention
        mask = None
        if shift_size > 0:
            xn = torch.roll(xn, (-shift_size, -shift_size), dims=(1, 2))
            mask = _shift_mask_tensor(h, w, window_size, shift_size, x.device)
        if self.fused_attn:
            xn = self.attn.fused(xn, window_size, mask)
        else:
            xn = self.attn.windowed(xn, window_size, mask)
        if shift_size > 0:
            xn = torch.roll(xn, (shift_size, shift_size), dims=(1, 2))
        x = x + xn.permute(0, 3, 1, 2)
        return x + self.mlp(self.norm2(x))


class _Embed(nn.Module):
    """A 1x1 conv (key ``proj``) and an optional GroupNorm (key ``norm``)."""

    def __init__(self, in_chans: int, out_chans: int, norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, out_chans, 1)
        self.norm = group_norm(out_chans) if norm else None

    def forward(self, x):
        x = self.proj(x)
        return x if self.norm is None else self.norm(x)


class BasicLayer(nn.Module):
    """Patch embed (1x1 conv) -> ``depth`` Swin blocks, shifted every other
    one -> patch unembed (1x1 conv). Inside, the map is kept in the
    channels-last memory format, so that the (B, H, W, C) view the attention
    takes is contiguous and no layout copy is made around it."""

    def __init__(self, in_chans: int, embed_dim: int, num_heads: int, window_size: int,
                 depth: int = 2, mlp_ratio: float = 2., patch_norm: bool = False,
                 fused_attn: bool = True):
        super().__init__()
        self.patch_embed = _Embed(in_chans, embed_dim, patch_norm)
        self.blocks = nn.ModuleList([
            SwinBlockGN(embed_dim, num_heads, window_size,
                        0 if i % 2 == 0 else window_size // 2, mlp_ratio, fused_attn)
            for i in range(depth)])
        self.patch_unembed = _Embed(embed_dim, in_chans, patch_norm)

    def forward(self, x):
        x = self.patch_embed(x.contiguous(memory_format=torch.channels_last))
        for block in self.blocks:
            x = block(x)
        return self.patch_unembed(x)


class TimestepEmbedSequential(nn.Sequential):
    """A Sequential that hands the timestep embedding to its residual blocks."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, (ResBlock, ResBlockConv)) else layer(x)
        return x


# JAX package parameter path (after utils/jax_convert's generic rules) -> BasicSR key
_UNET_JAX_KEY_RULES = (
    (r'patch_(un)?embed_(proj|norm)\.', r'patch_\1embed.\2.'),
    (r'mlp_fc([12])\.', r'mlp.fc\1.'),
    (r'label_emb\.embedding$', 'label_emb.weight'),
)


class _ADMUNet(nn.Module):
    """What the three UNets share: the timestep MLP, the down path with its
    skip connections, the middle, the up path and the seeded init. A
    subclass says which residual block it uses (``_res``), what follows one
    (``_attention``) and builds ``middle_block`` and ``out``."""

    JAX_KEY_RULES = _UNET_JAX_KEY_RULES

    def _build(self, first_in_channels: int, model_channels: int, num_res_blocks,
               channel_mult: Sequence[int], conv_resample: bool, resblock_updown: bool,
               image_size: Optional[int]):
        self.model_channels = model_channels
        time_embed_dim = self.time_embed_dim = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, time_embed_dim), nn.SiLU(),
                                        nn.Linear(time_embed_dim, time_embed_dim))
        levels = len(channel_mult)
        num_res_blocks = per_level(num_res_blocks, levels)
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(nn.Conv2d(first_in_channels, ch, 3, padding=1))])
        chans = [ch]
        ds = image_size
        for level, mult in enumerate(channel_mult):
            for j in range(num_res_blocks[level]):
                out_ch = int(mult * model_channels)
                layers = [self._res(ch, out_ch)]
                ch = out_ch
                layers += self._attention(ch, ds, j)
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != levels - 1:
                down = (self._res(ch, ch, down=True) if resblock_updown
                        else ADMDownsample(ch, conv_resample, ch))
                self.input_blocks.append(TimestepEmbedSequential(down))
                chans.append(ch)
                if ds is not None:
                    ds //= 2
        self.middle_block = TimestepEmbedSequential(*self._middle(ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks[level] + 1):
                out_ch = int(model_channels * mult)
                layers = [self._res(ch + chans.pop(), out_ch)]
                ch = out_ch
                layers += self._attention(ch, ds, i)
                if level and i == num_res_blocks[level]:
                    layers.append(self._res(ch, ch, up=True) if resblock_updown
                                  else ADMUpsample(ch, conv_resample, ch))
                    if ds is not None:
                        ds *= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        return ch

    def _attention(self, ch: int, ds: Optional[int], index: int):
        return []

    def _embed(self, timesteps):
        return self.time_embed(timestep_embedding(timesteps, self.model_channels))

    def _trunk(self, h, emb):
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init: convs and Linears torch's default distribution, the
        Swin layers' Linears and bias tables trunc-normal (std .02) with zero
        biases, GroupNorm 1/0, the zero-initialised convs zero weights."""
        swin_linears = {id(m) for layer in self.modules() if isinstance(layer, BasicLayer)
                        for m in layer.modules() if isinstance(m, nn.Linear)}
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv1d, nn.Linear)):
                default_conv_init_(m, generator)
                if id(m) in swin_linears:
                    trunc_normal_(m.weight, .02, generator)
                    m.bias.zero_()
                if getattr(m, 'zero_init', False):
                    m.weight.zero_()
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                trunc_normal_(m.relative_position_bias_table, .02, generator)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, generator=generator)


@ARCH_REGISTRY.register()
class UNetModelSwin(_ADMUNet):
    """The ResShift denoiser: an ADM UNet whose attention stages, after the
    first residual block of each listed resolution and in the middle, are
    ``BasicLayer``s of Swin blocks. ``forward(x, timesteps, lq=None,
    mask=None)``: x (B, in_channels, S, S), timesteps (B,), lq (B,
    lq_channels, lq_size, lq_size). ``dims`` and ``use_fp16`` are accepted
    for the published configs and must be 2 and false. ``fused_attn``: see
    ``SwinBlockGN``."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks=2, attention_resolutions: Sequence[int] = (64, 32),
                 dropout: float = 0., channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, dims: int = 2, use_fp16: bool = False,
                 num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 swin_depth: int = 2, swin_embed_dim: int = 96, window_size: int = 8,
                 mlp_ratio: float = 2.0, patch_norm: bool = False, cond_lq: bool = True,
                 cond_mask: bool = False, lq_size: int = 256, lq_channels: Optional[int] = None,
                 fused_attn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dims != 2 or use_fp16:
            raise NotImplementedError('UNetModelSwin: dims 2 and use_fp16 false are ported')
        self.image_size, self.lq_size = image_size, lq_size
        self.cond_lq, self.cond_mask = cond_lq, cond_mask
        self.dropout, self.use_scale_shift_norm = dropout, use_scale_shift_norm
        self.attention_resolutions = tuple(attention_resolutions)
        self.swin = dict(embed_dim=swin_embed_dim, window_size=window_size, depth=swin_depth,
                         mlp_ratio=mlp_ratio, patch_norm=patch_norm, fused_attn=fused_attn,
                         num_heads=(num_heads if num_head_channels == -1
                                    else swin_embed_dim // num_head_channels))
        first = in_channels
        if cond_lq:
            feat = (lq_channels or in_channels) + (1 if cond_mask else 0)
            if lq_size != image_size:
                layers, base = [], 16
                for _ in range(int(math.log(lq_size / image_size) / math.log(2))):
                    layers += [nn.Conv2d(feat, base, 3, padding=1), nn.SiLU(),
                               ADMDownsample(base, True, base * 2)]
                    feat = base = base * 2
                self.feature_extractor = nn.Sequential(*layers)
            first += feat
        ch = self._build(first, model_channels, num_res_blocks, channel_mult, conv_resample,
                         resblock_updown, image_size)
        self.out = nn.Sequential(group_norm(ch), nn.SiLU(),
                                 _zero(nn.Conv2d(ch, out_channels, 3, padding=1)))
        self.reset_parameters(generator)

    def _res(self, ch_in, ch_out, **kw):
        return ResBlock(ch_in, self.time_embed_dim, self.dropout, out_channels=ch_out,
                        use_scale_shift_norm=self.use_scale_shift_norm, **kw)

    def _attention(self, ch, ds, index):
        if ds in self.attention_resolutions and index == 0:
            return [BasicLayer(ch, **self.swin)]
        return []

    def _middle(self, ch):
        return [self._res(ch, ch), BasicLayer(ch, **self.swin), self._res(ch, ch)]

    def forward(self, x, timesteps, lq=None, mask=None):
        emb = self._embed(timesteps)
        if lq is not None:
            if not self.cond_lq:
                raise ValueError('UNetModelSwin: lq given to a network built with cond_lq false')
            if mask is not None:
                if not self.cond_mask:
                    raise ValueError('UNetModelSwin: mask given, cond_mask is false')
                lq = torch.cat([lq, mask], dim=1)
            if self.lq_size != self.image_size:
                lq = self.feature_extractor(lq)
            if lq.shape[-1] != x.shape[-1]:
                lq = resize_bicubic(lq, x.shape[-1] / lq.shape[-1])
            x = torch.cat([x, lq.to(x.dtype)], dim=1)
        return self._trunk(x, emb)


@ARCH_REGISTRY.register()
class UNetModel(_ADMUNet):
    """The ADM UNet with global attention blocks after every residual block
    of the listed resolutions. ``forward(x, timesteps, y=None, lq=None)``;
    ``y`` (B,) class labels when ``num_classes`` is set."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks=2, attention_resolutions: Sequence[int] = (32, 16),
                 cond_lq: bool = True, dropout: float = 0.,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = 1,
                 num_head_channels: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, lq_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cond_lq = cond_lq
        self.dropout, self.use_scale_shift_norm = dropout, use_scale_shift_norm
        self.attention_resolutions = tuple(attention_resolutions)
        self.heads = (num_heads, num_head_channels)
        first = in_channels + ((lq_channels or in_channels) if cond_lq else 0)
        ch = self._build(first, model_channels, num_res_blocks, channel_mult, conv_resample,
                         resblock_updown, image_size)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, self.time_embed_dim)
        self.num_classes = num_classes
        self.out = nn.Sequential(group_norm(ch), nn.SiLU(),
                                 _zero(nn.Conv2d(ch, out_channels, 3, padding=1)))
        self.reset_parameters(generator)

    def _res(self, ch_in, ch_out, **kw):
        return ResBlock(ch_in, self.time_embed_dim, self.dropout, out_channels=ch_out,
                        use_scale_shift_norm=self.use_scale_shift_norm, **kw)

    def _attention(self, ch, ds, index):
        return [AttentionBlock(ch, *self.heads)] if ds in self.attention_resolutions else []

    def _middle(self, ch):
        return [self._res(ch, ch), AttentionBlock(ch, *self.heads), self._res(ch, ch)]

    def forward(self, x, timesteps, y=None, lq=None):
        emb = self._embed(timesteps)
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)
        if lq is not None:
            if not self.cond_lq:
                raise ValueError('UNetModel: lq given to a network built with cond_lq false')
            if lq.shape[-1] != x.shape[-1]:
                lq = resize_bicubic(lq, x.shape[-1] / lq.shape[-1])
            x = torch.cat([x, lq.to(x.dtype)], dim=1)
        return self._trunk(x, emb)


@ARCH_REGISTRY.register()
class UNetModelConv(_ADMUNet):
    """Attention-free, norm-free conv UNet with a timestep embedding. An lq
    of another size than x is pixel-unshuffled by 2 (``lq_channels`` counts
    its channels as concatenated)."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks=2, cond_lq: bool = True,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 lq_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cond_lq, self.use_scale_shift_norm = cond_lq, use_scale_shift_norm
        first = in_channels + ((lq_channels or in_channels) if cond_lq else 0)
        ch = self._build(first, model_channels, num_res_blocks, channel_mult, conv_resample,
                         resblock_updown, None)
        self.out = nn.Sequential(nn.SiLU(), nn.Conv2d(ch, out_channels, 3, padding=1))
        self.reset_parameters(generator)

    def _res(self, ch_in, ch_out, **kw):
        return ResBlockConv(ch_in, self.time_embed_dim, out_channels=ch_out,
                            use_scale_shift_norm=self.use_scale_shift_norm, **kw)

    def _middle(self, ch):
        return [self._res(ch, ch), self._res(ch, ch)]

    def forward(self, x, timesteps, lq=None):
        emb = self._embed(timesteps)
        if lq is not None:
            if not self.cond_lq:
                raise ValueError('UNetModelConv: lq given to a network built with cond_lq false')
            if lq.shape[-1] != x.shape[-1]:
                lq = pixel_unshuffle(lq, 2)
            x = torch.cat([x, lq.to(x.dtype)], dim=1)
        return self._trunk(x, emb)
