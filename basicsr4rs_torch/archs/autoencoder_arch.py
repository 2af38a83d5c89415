"""First-stage autoencoders of ResShift's latent diffusion (counterpart of
``basicsr4rs_tpu/archs/autoencoder_arch.py``; reference:
basicsr/archs/autoencoder_arch.py with archs/resshift/{model,quantize,
distributions}.py).

LDM-style ``Encoder``/``Decoder`` (GroupNorm with eps 1e-6 and swish
``ResnetBlock``s, single-head ``AttnBlock``s, a downsample that pads (0, 1,
0, 1) and convolves without padding), a nearest-code ``VectorQuantizer``
with straight-through gradients, and a diagonal-Gaussian KL head. NCHW,
BasicSR's module tree and key names (``encoder.down.N.block.M``,
``decoder.up.N.upsample.conv``, ``quantize.embedding.weight``). They run no
hand-written kernel: convolutions and norms go to cuDNN and PyTorch.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import default_conv_init_, per_level, resize_nearest


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_ch, 3, padding=1)
        self.norm2 = _norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if out_ch != in_channels:
            if conv_shortcut:
                self.conv_shortcut = nn.Conv2d(in_channels, out_ch, 3, padding=1)
            else:
                self.nin_shortcut = nn.Conv2d(in_channels, out_ch, 1)

    def forward(self, x):
        h = self.conv1(_swish(self.norm1(x)))
        h = self.conv2(self.dropout(_swish(self.norm2(h))))
        if hasattr(self, 'conv_shortcut'):
            x = self.conv_shortcut(x)
        elif hasattr(self, 'nin_shortcut'):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over all H*W positions, 1x1 convs for q, k, v
    and the output projection, residual."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = _norm(in_channels)
        self.q = nn.Conv2d(in_channels, in_channels, 1)
        self.k = nn.Conv2d(in_channels, in_channels, 1)
        self.v = nn.Conv2d(in_channels, in_channels, 1)
        self.proj_out = nn.Conv2d(in_channels, in_channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (f(hn).reshape(b, c, h * w) for f in (self.q, self.k, self.v))
        attn = torch.softmax(torch.einsum('bcq,bck->bqk', q, k) * (c ** -0.5), dim=-1)
        out = torch.einsum('bqk,bck->bcq', attn, v).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 3x3 conv without padding
    (key ``conv``); or a 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)
        self.with_conv = with_conv

    def forward(self, x):
        if self.with_conv:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class _Upsample(nn.Module):
    """Nearest x2, then an optional 3x3 conv (key ``conv``)."""

    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.with_conv = with_conv

    def forward(self, x):
        x = resize_nearest(x, 2)
        return self.conv(x) if self.with_conv else x


def _level(blocks, attns) -> nn.Module:
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(blocks), nn.ModuleList(attns)
    return level


def _mid(channels: int, dropout: float) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels, dropout=dropout)
    mid.attn_1 = AttnBlock(channels)
    mid.block_2 = ResnetBlock(channels, channels, dropout=dropout)
    return mid


def _run_level(level, h):
    for i, block in enumerate(level.block):
        h = block(h)
        if len(level.attn) > 0:
            h = level.attn[i](h)
    return h


class Encoder(nn.Module):

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks,
                 attn_resolutions: Sequence[int], in_channels: int, resolution: int,
                 z_channels: int, dropout: float = 0., resamp_with_conv: bool = True,
                 double_z: bool = True):
        super().__init__()
        levels = len(ch_mult)
        num_res_blocks = per_level(num_res_blocks, levels)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        curr_res = resolution
        self.down = nn.ModuleList()
        for i_level in range(levels):
            block_in, block_out = ch * in_ch_mult[i_level], ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks[i_level]):
                blocks.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level = _level(blocks, attns)
            if i_level != levels - 1:
                level.downsample = _Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in, dropout)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, 'downsample'):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(_swish(self.norm_out(h)))


class Decoder(nn.Module):

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks,
                 attn_resolutions: Sequence[int], in_channels: int, resolution: int,
                 z_channels: int, dropout: float = 0., resamp_with_conv: bool = True,
                 give_pre_end: bool = False, tanh_out: bool = False):
        super().__init__()
        levels = len(ch_mult)
        num_res_blocks = per_level(num_res_blocks, levels)
        self.give_pre_end, self.tanh_out = give_pre_end, tanh_out
        block_in = ch * ch_mult[levels - 1]
        curr_res = resolution // 2 ** (levels - 1)
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _mid(block_in, dropout)
        up = []
        for i_level in reversed(range(levels)):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks[i_level] + 1):
                blocks.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level = _level(blocks, attns)
            if i_level != 0:
                level.upsample = _Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            up.insert(0, level)   # stored by level index, run from the deepest
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, 'upsample'):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        h = self.conv_out(_swish(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer with straight-through gradients. For z
    (B, e_dim, H, W) returns (z_q, loss, indices (B, H, W)); distances are
    |z|^2 - 2 z.e + |e|^2 over the ``n_e`` codes, the first smallest wins."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)

    def distances(self, z):
        """(B*H*W, n_e) squared distances of every position to every code."""
        flat = z.permute(0, 2, 3, 1).reshape(-1, self.e_dim)
        emb = self.embedding.weight
        return (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ emb.t() + emb.pow(2).sum(1)[None])

    def forward(self, z):
        b, _, h, w = z.shape
        idx = torch.argmin(self.distances(z), dim=1)
        z_q = self.embedding(idx).reshape(b, h, w, self.e_dim).permute(0, 3, 1, 2)
        loss = (self.beta * (z_q.detach() - z).pow(2).mean() + (z_q - z.detach()).pow(2).mean())
        z_q = z + (z_q - z).detach()   # straight-through
        return z_q, loss, idx.reshape(b, h, w)

    def embed_code(self, code):
        return self.embedding(code)


class DiagonalGaussianDistribution:
    """A diagonal Gaussian from (B, 2C, ...) parameters: mean | log-variance
    along the channels, the log-variance clipped to [-30, 20]."""

    def __init__(self, parameters: torch.Tensor):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise=None):
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self):
        return self.mean

    def kl(self, other=None):
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean.pow(2) + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean).pow(2) / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=dims)

    def nll(self, sample):
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(np.log(2.0 * np.pi) + self.logvar
                               + (sample - self.mean).pow(2) / self.var, dim=dims)


def _filter(cls, ddconfig: dict) -> dict:
    """The entries of ``ddconfig`` that ``cls`` takes (``double_z`` is set
    by the model)."""
    names = set(inspect.signature(cls.__init__).parameters) - {'self', 'double_z'}
    return {k: v for k, v in ddconfig.items() if k in names}


# JAX package parameter path (after utils/jax_convert's generic rules) -> BasicSR key
_AE_JAX_KEY_RULES = (
    (r'\.(down|up)_(\d+)_(block|attn)\.(\d+)\.', r'.\1.\2.\3.\4.'),
    (r'\.down_(\d+)_downsample_conv\.', r'.down.\1.downsample.conv.'),
    (r'\.up_(\d+)_upsample_conv\.', r'.up.\1.upsample.conv.'),
    (r'\.mid_(block|attn)\.(\d)\.', r'.mid.\1_\2.'),
    (r'quantize\.embedding$', 'quantize.embedding.weight'),
)


@torch.no_grad()
def _seeded_init(net: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Convs torch's default distribution, GroupNorm 1/0, the codebook
    uniform in [-1/n_e, 1/n_e], all from ``generator``."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            default_conv_init_(m, generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-1. / m.num_embeddings, 1. / m.num_embeddings, generator=generator)


@ARCH_REGISTRY.register()
class VQModelTorch(nn.Module):
    """VQ first stage: ``encode`` to the pre-quantization latent, ``decode``
    quantizes (unless ``force_not_quantize``) and decodes."""

    JAX_KEY_RULES = _AE_JAX_KEY_RULES

    def __init__(self, ddconfig: dict, n_embed: int, embed_dim: int,
                 sane_index_shape: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(ddconfig)
        self.encoder = Encoder(**_filter(Encoder, dd), double_z=False)
        self.decoder = Decoder(**_filter(Decoder, dd))
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=0.25)
        self.quant_conv = nn.Conv2d(dd['z_channels'], embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd['z_channels'], 1)
        _seeded_init(self, generator)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, h, force_not_quantize: bool = False):
        quant = h if force_not_quantize else self.quantize(h)[0]
        return self.decoder(self.post_quant_conv(quant))

    def forward(self, x, force_not_quantize: bool = False):
        return self.decode(self.encode(x), force_not_quantize)


@ARCH_REGISTRY.register()
class AutoencoderKLTorch(nn.Module):
    """KL first stage: ``encode`` returns the posterior's mode, or a sample
    drawn with ``generator`` (or from given ``noise``)."""

    JAX_KEY_RULES = _AE_JAX_KEY_RULES

    def __init__(self, ddconfig: dict, embed_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(ddconfig)
        if not dd.get('double_z', True):
            raise ValueError('AutoencoderKLTorch needs ddconfig.double_z true')
        self.encoder = Encoder(**_filter(Encoder, dd), double_z=True)
        self.decoder = Decoder(**_filter(Decoder, dd))
        self.quant_conv = nn.Conv2d(2 * dd['z_channels'], 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd['z_channels'], 1)
        _seeded_init(self, generator)

    def encode(self, x, sample_posterior: bool = False, generator=None,
               return_moments: bool = False, noise=None):
        moments = self.quant_conv(self.encoder(x))
        posterior = DiagonalGaussianDistribution(moments)
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return (z, moments) if return_moments else z

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, sample_posterior: bool = False, generator=None):
        return self.decode(self.encode(x, sample_posterior, generator))


@ARCH_REGISTRY.register()
class IdentityFirstStage(nn.Module):

    def __init__(self, vq_interface: bool = False):
        super().__init__()
        self.vq_interface = vq_interface

    def encode(self, x, *args, **kwargs):
        return x

    def decode(self, x, *args, **kwargs):
        return x

    def forward(self, x, *args, **kwargs):
        return x
