"""SR3, the diffusion SR UNet conditioned on a continuous noise level
(counterpart of ``basicsr4rs_tpu/archs/sr3_arch.py``; reference:
basicsr/archs/sr3_arch.py).

BasicSR's module tree and key names (``downs.N.res_block.block1.block.0``,
``noise_func.noise_func.0``, ``attn.qkv``, ``downs.N.conv``,
``noise_level_mlp.1``), which the JAX package's ``TORCH_KEY_RULES`` map
from; ``JAX_KEY_RULES`` map back. NCHW. The GroupNorms take
``min(norm_groups, C)`` groups and Flax's epsilon of 1e-6, as the JAX
modules do. The whole-map self-attention is a plain ``torch.matmul`` and
softmax: the JAX package computes it outside any Pallas kernel. The JAX
package has no model that trains or samples SR3, so neither has the port:
``SR3`` holds the network and the DDPM schedule's tables.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import default_conv_init_, resize_nearest


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """(n_timestep,) float64 betas of one of the seven schedules (reference
    sr3_arch.py:34-65)."""
    if schedule == 'quad':
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)**2
    if schedule == 'linear':
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule in ('warmup10', 'warmup50'):
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
        warm = int(n_timestep * (0.1 if schedule == 'warmup10' else 0.5))
        betas[:warm] = np.linspace(linear_start, linear_end, warm, dtype=np.float64)
        return betas
    if schedule == 'const':
        return linear_end * np.ones(n_timestep, dtype=np.float64)
    if schedule == 'jsd':   # 1/T, 1/(T-1), ..., 1
        return 1. / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    if schedule == 'cosine':
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * math.pi / 2)**2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], None, 0.999)
    raise NotImplementedError(schedule)


def positional_encoding(noise_level: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, dim) sin | cos encoding of the (B,) noise levels (reference
    sr3_arch.py:68-83)."""
    count = dim // 2
    step = torch.arange(count, dtype=noise_level.dtype, device=noise_level.device) / count
    enc = noise_level[:, None] * torch.exp(-math.log(1e4) * step[None])
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


class PositionalEncoding(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level):
        return positional_encoding(noise_level, self.dim)


def _group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, channels), channels, eps=1e-6)


class Block(nn.Module):
    """GroupNorm, swish, dropout (when given), 3x3 conv (reference
    sr3_arch.py:131-142; keys ``block.0``, ``block.3``)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32, dropout: float = 0.):
        super().__init__()
        self.block = nn.Sequential(_group_norm(groups, dim), nn.SiLU(),
                                   nn.Dropout(dropout) if dropout else nn.Identity(),
                                   nn.Conv2d(dim, dim_out, 3, padding=1))

    def forward(self, x):
        return self.block(x)


class FeatureWiseAffine(nn.Module):
    """The noise embedding as a per-channel shift, or with
    ``use_affine_level`` as ``(1 + gamma) x + beta`` (FiLM; reference
    sr3_arch.py:86-104)."""

    def __init__(self, in_channels: int, out_channels: int, use_affine_level: bool = False):
        super().__init__()
        self.use_affine_level = use_affine_level
        self.noise_func = nn.Sequential(
            nn.Linear(in_channels, out_channels * (1 + use_affine_level)))

    def forward(self, x, noise_embed):
        noise = self.noise_func(noise_embed)[:, :, None, None]
        if self.use_affine_level:
            gamma, beta = noise.chunk(2, dim=1)
            return (1 + gamma) * x + beta
        return x + noise


class ResnetBlock(nn.Module):
    """block1, the noise's FiLM, block2 (with the dropout), + ``res_conv``
    of x (a 1x1 conv when the widths differ) (reference sr3_arch.py:145-170)."""

    def __init__(self, dim: int, dim_out: int, noise_level_emb_dim: int, dropout: float = 0.,
                 use_affine_level: bool = False, norm_groups: int = 32):
        super().__init__()
        self.noise_func = FeatureWiseAffine(noise_level_emb_dim, dim_out, use_affine_level)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups, dropout=dropout)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb):
        h = self.noise_func(self.block1(x), time_emb)
        return self.block2(h) + self.res_conv(x)


class SelfAttention(nn.Module):
    """One head over all H*W positions: GroupNorm, a 1x1 conv to q|k|v (no
    bias), softmax(q k^T / sqrt(C)) v, a 1x1 conv, + x (reference
    sr3_arch.py:173-194)."""

    def __init__(self, in_channel: int, norm_groups: int = 32):
        super().__init__()
        self.norm = _group_norm(norm_groups, in_channel)
        self.qkv = nn.Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv(self.norm(x)).reshape(b, 3, c, h * w).unbind(1)
        attn = torch.softmax(torch.matmul(q.transpose(1, 2), k) / math.sqrt(c), dim=-1)
        out = torch.matmul(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.out(out)


class ResnetBlocWithAttn(nn.Module):
    """A ``ResnetBlock`` and, with ``with_attn``, a ``SelfAttention`` after
    it (reference sr3_arch.py:197-210)."""

    def __init__(self, dim: int, dim_out: int, *, noise_level_emb_dim: int,
                 norm_groups: int = 32, dropout: float = 0., with_attn: bool = False,
                 use_affine_level: bool = False):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, noise_level_emb_dim, dropout,
                                     use_affine_level, norm_groups)
        self.attn = SelfAttention(dim_out, norm_groups) if with_attn else None

    def forward(self, x, time_emb):
        x = self.res_block(x, time_emb)
        return x if self.attn is None else self.attn(x)


class Downsample(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv(resize_nearest(x, 2))


# JAX package parameter path (after utils/jax_convert's generic rules) ->
# BasicSR key; the inverse of the JAX SR3UNet's TORCH_KEY_RULES. Matched at
# the start of the key or after a dot, so that ``SR3``'s ``unet.`` prefix
# takes them too
_SR3_JAX_KEY_RULES = (
    (r'(block[12]|final_conv)\.norm\.', r'\1.block.0.'),
    (r'(block[12]|final_conv)\.conv\.', r'\1.block.3.'),
    (r'\.noise_func\.', '.noise_func.noise_func.0.'),
    (r'\.attn_(norm|qkv|out)\.', r'.attn.\1.'),
    (r'(^|\.)((?:downs|mid|ups)\.\d+)\.(block[12]|noise_func|res_conv)\.', r'\1\2.res_block.\3.'),
    (r'(^|\.)(downs\.(?!0\.)\d+|ups\.\d+)\.(weight|bias)$', r'\1\2.conv.\3'),
    (r'(^|\.)noise_mlp\.', r'\1noise_level_mlp.'),
)


@ARCH_REGISTRY.register()
class SR3UNet(nn.Module):
    """(reference sr3_arch.py:212-318, class UNet). ``forward(x, time)``: x
    (B, in_channel, S, S) with S = ``image_size`` (a multiple of 2 to the
    number of levels less one), time (B,) the noise levels; returns (B,
    out_channel, S, S). Attention follows every residual block of a level
    whose resolution is in ``attn_res``, and the first middle block.
    ``generator`` seeds the init (torch's default distributions)."""

    JAX_KEY_RULES = _SR3_JAX_KEY_RULES

    def __init__(self, in_channel: int = 6, out_channel: int = 3, inner_channel: int = 32,
                 norm_groups: int = 32, channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
                 attn_res: Sequence[int] = (8,), res_blocks: int = 3, dropout: float = 0.,
                 with_noise_level_emb: bool = True, image_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not with_noise_level_emb:
            # the blocks' noise_func needs the embedding: the JAX forward
            # fails without it too
            raise ValueError('SR3UNet: with_noise_level_emb false is not supported')
        self.noise_level_mlp = nn.Sequential(
            PositionalEncoding(inner_channel), nn.Linear(inner_channel, inner_channel * 4),
            nn.SiLU(), nn.Linear(inner_channel * 4, inner_channel))

        def res(dim, dim_out, with_attn):
            return ResnetBlocWithAttn(dim, dim_out, noise_level_emb_dim=inner_channel,
                                      norm_groups=norm_groups, dropout=dropout,
                                      with_attn=with_attn)

        levels = len(channel_mults)
        pre, now_res = inner_channel, image_size
        feat_channels = [pre]
        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for ind, mult in enumerate(channel_mults):
            use_attn = now_res in attn_res
            ch = inner_channel * mult
            for _ in range(res_blocks):
                downs.append(res(pre, ch, use_attn))
                feat_channels.append(ch)
                pre = ch
            if ind != levels - 1:
                downs.append(Downsample(pre))
                feat_channels.append(pre)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([res(pre, pre, True), res(pre, pre, False)])
        ups = []
        for ind in reversed(range(levels)):
            use_attn = now_res in attn_res
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(res(pre + feat_channels.pop(), ch, use_attn))
                pre = ch
            if ind > 0:
                ups.append(Upsample(pre))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, groups=norm_groups)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default init of every conv and Linear, from ``generator``;
        GroupNorm 1/0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                default_conv_init_(m, generator)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        t = self.noise_level_mlp(time)
        feats = []
        for layer in self.downs:
            x = layer(x, t) if isinstance(layer, ResnetBlocWithAttn) else layer(x)
            feats.append(x)
        for layer in self.mid:
            x = layer(x, t)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                x = layer(torch.cat([x, feats.pop()], dim=1), t)
            else:
                x = layer(x)
        return self.final_conv(x)


@ARCH_REGISTRY.register()
class SR3(nn.Module):
    """SR3's network (``unet``, built from ``unet_opt``) and the DDPM
    schedule of ``schedule_opt`` (reference sr3_arch.py:319-380). Sampling
    and training belong to a model, which neither package has;
    ``in_channels``, ``image_size`` and ``conditional`` are that model's
    settings, taken as the reference's configs write them and unused here."""

    JAX_KEY_RULES = _SR3_JAX_KEY_RULES

    def __init__(self, unet_opt: dict, schedule_opt: dict, in_channels: int = 3,
                 image_size: int = 512, conditional: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.schedule_opt = dict(schedule_opt)
        self.unet = SR3UNet(**unet_opt, generator=generator)

    def make_schedule(self) -> dict:
        """The twelve float64 numpy tables of the schedule."""
        opt = self.schedule_opt
        betas = make_beta_schedule(opt['schedule'], opt['n_timestep'],
                                   opt.get('linear_start', 1e-4), opt.get('linear_end', 2e-2))
        alphas = 1. - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1., alphas_cumprod[:-1])
        posterior_variance = betas * (1. - alphas_cumprod_prev) / (1. - alphas_cumprod)
        return {
            'betas': betas,
            'alphas_cumprod': alphas_cumprod,
            'alphas_cumprod_prev': alphas_cumprod_prev,
            'sqrt_alphas_cumprod_prev': np.sqrt(np.append(1., alphas_cumprod)),
            'sqrt_alphas_cumprod': np.sqrt(alphas_cumprod),
            'sqrt_one_minus_alphas_cumprod': np.sqrt(1. - alphas_cumprod),
            'sqrt_recip_alphas_cumprod': np.sqrt(1. / alphas_cumprod),
            'sqrt_recipm1_alphas_cumprod': np.sqrt(1. / alphas_cumprod - 1),
            'posterior_variance': posterior_variance,
            'posterior_log_variance_clipped': np.log(np.maximum(posterior_variance, 1e-20)),
            'posterior_mean_coef1': betas * np.sqrt(alphas_cumprod_prev) / (1. - alphas_cumprod),
            'posterior_mean_coef2': (1. - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1. - alphas_cumprod),
        }

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        return self.unet(x, time)
