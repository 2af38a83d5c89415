"""HiFaceGAN's blocks: SPADE, the SPADE residual block, local-importance
pooling and its encoder (counterpart of
``basicsr4rs_tpu/archs/hifacegan_util.py``; reference:
basicsr/archs/hifacegan_util.py).

NCHW, module names as the JAX package's (``jax_convert`` plus the
generator's ``JAX_KEY_RULES`` carry its parameters over). What the obvious
PyTorch modules would compute otherwise:

* spectral normalisation is the port's exact ``spectral_normalize``
  (``discriminator_arch``), the weight ``weight_orig``;
* SPADE's ``batch`` norm always normalises by the batch's own statistics,
  in eval too, and keeps no running buffers (``nn.BatchNorm2d`` in eval
  mode would use its running ones); in training on several ranks
  (``sync_ranks``) by the global batch's, in eval by the rank's own (a
  rank validates alone); ``instance`` and ``syncbatch`` are an instance
  norm;
* ``nearest_resize_to`` takes source index ``floor(dst * in / out)``, the
  JAX package's rule, not ``F.interpolate``'s float scale;
* the LIP gate's affine instance norm is a ``GroupNorm`` of one channel a
  group with Flax's epsilon, 1e-6.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .arch_util import global_batch_moments
from .discriminator_arch import spectral_normalize


def nearest_resize_to(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize of NCHW to ``size``: source index floor(dst * in / out)
    on each axis, computed in integers."""
    h, w = x.shape[2:]
    th, tw = size
    if (th, tw) == (h, w):
        return x
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(2, rows).index_select(3, cols)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over (H, W), biased variance."""
    var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm(x: torch.Tensor, eps: float = 1e-5, sync: bool = False) -> torch.Tensor:
    """Parameter-free norm by the batch's statistics over (N, H, W); with
    ``sync`` by the global batch's (``global_batch_moments``), as
    ``jnp.mean`` and ``jnp.var`` over the JAX mesh's sharded batch."""
    if not sync:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    centred, _, var = global_batch_moments(x)
    return centred * torch.rsqrt(var + eps).view(1, -1, 1, 1)


def avg_pool_3x3s2(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=count_include_pad)


def lip2d(x: torch.Tensor, logit: torch.Tensor) -> torch.Tensor:
    """Local-importance pooling: the 3x3 / 2 average of x weighted by
    exp(logit)."""
    weight = logit.exp()
    return avg_pool_3x3s2(x * weight) / avg_pool_3x3s2(weight)


class SNConv2d(nn.Module):
    """A spectrally normalised convolution with explicit padding and
    dilation (``weight_orig``, as ``torch.nn.utils.spectral_norm`` names
    it). A state_dict may also hand the weight over as ``weight``: the
    JAX package's spectral-norm convolutions name theirs ``kernel``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, dilation: int = 1):
        super().__init__()
        conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         bias=bias)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_orig = conv.weight
        self.bias = conv.bias

    def forward(self, x):
        return F.conv2d(x, spectral_normalize(self.weight_orig).to(x.dtype), self.bias,
                        self.stride, self.padding, self.dilation)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in ('weight_u', 'weight_v'):   # the power iteration's state
            state_dict.pop(prefix + key, None)
        if prefix + 'weight' in state_dict and prefix + 'weight_orig' not in state_dict:
            state_dict[prefix + 'weight_orig'] = state_dict.pop(prefix + 'weight')
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def conv2d(in_channels: int, out_channels: int, kernel_size: int, padding: int,
           bias: bool = True, spectral: bool = False) -> nn.Module:
    if spectral:
        return SNConv2d(in_channels, out_channels, kernel_size, 1, padding, bias=bias)
    return nn.Conv2d(in_channels, out_channels, kernel_size, 1, padding, bias=bias)


class SPADE(nn.Module):
    """Spatially-adaptive denormalisation: the param-free norm of x, times
    gamma plus beta, both convolved from the segmentation map resized to
    x. ``config_text`` is ``spade<norm><k>x<k>``."""

    sync_ranks = False   # the global batch's ``batch`` statistics in training

    def __init__(self, config_text: str, norm_nc: int, label_nc: int):
        super().__init__()
        parsed = re.search(r'spade(\D+)(\d)x\d', config_text)
        self.norm_type, ks = str(parsed.group(1)), int(parsed.group(2))
        if self.norm_type not in ('instance', 'syncbatch', 'batch'):
            raise ValueError(f'{self.norm_type} is not a recognized param-free norm type in '
                             'SPADE')
        nhidden = 128 if norm_nc > 128 else norm_nc
        pw = ks // 2
        self.mlp_shared = nn.Sequential(nn.Conv2d(label_nc, nhidden, ks, padding=pw), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw, bias=False)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw, bias=False)

    def forward(self, x, segmap):
        normalized = (batch_norm(x, sync=self.training and self.sync_ranks)
                      if self.norm_type == 'batch' else instance_norm(x))
        actv = self.mlp_shared(nearest_resize_to(segmap, x.shape[2:]))
        return normalized * self.mlp_gamma(actv) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    """Two SPADE, leaky ReLU, conv stages and a learnt shortcut (SPADE and a
    1x1 convolution) where the widths differ; spectral convolutions when
    ``norm_g`` says ``spectral``."""

    def __init__(self, fin: int, fout: int, norm_g: str = 'spectralspadesyncbatch3x3',
                 semantic_nc: int = 3):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        spectral = 'spectral' in norm_g
        spade_config_str = norm_g.replace('spectral', '')
        self.conv_0 = conv2d(fin, fmiddle, 3, 1, spectral=spectral)
        self.conv_1 = conv2d(fmiddle, fout, 3, 1, spectral=spectral)
        if self.learned_shortcut:
            self.conv_s = conv2d(fin, fout, 1, 0, bias=False, spectral=spectral)
            self.norm_s = SPADE(spade_config_str, fin, semantic_nc)
        self.norm_0 = SPADE(spade_config_str, fin, semantic_nc)
        self.norm_1 = SPADE(spade_config_str, fmiddle, semantic_nc)

    def forward(self, x, seg):
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx


class InstanceNorm(nn.Module):

    def forward(self, x):
        return instance_norm(x)


class SoftGate(nn.Module):
    COEFF = 12.0

    def forward(self, x):
        return torch.sigmoid(x) * self.COEFF


class SimplifiedLIP(nn.Module):
    """LIP with its logits from a 3x3 convolution, an affine instance norm
    and a 12 * sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.logit = nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1, bias=False),
                                   nn.GroupNorm(channels, channels, eps=1e-6), SoftGate())

    def forward(self, x):
        return lip2d(x, self.logit(x))


class LIPEncoder(nn.Module):
    """A 3x3 convolution, then ``n_2xdown`` halvings, each LIP, a 3x3
    convolution to up to 16 times ``ngf`` and an instance norm (ReLU between
    them); the ``model`` indices are BasicSR's."""

    def __init__(self, input_nc: int, ngf: int, sw: int, sh: int, n_2xdown: int):
        super().__init__()
        self.sw, self.sh = sw, sh
        max_ratio = 16
        model = [nn.Conv2d(input_nc, ngf, 3, 1, 1, bias=False), InstanceNorm(), nn.ReLU()]
        cur = 1
        for i in range(n_2xdown):
            nxt = min(cur * 2, max_ratio)
            model += [SimplifiedLIP(ngf * cur), nn.Conv2d(ngf * cur, ngf * nxt, 3, 1, 1),
                      InstanceNorm()]
            cur = nxt
            if i < n_2xdown - 1:
                model += [nn.ReLU()]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return self.model(x)
