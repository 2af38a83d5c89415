"""HiFaceGAN's SPADE generator and its multiscale conditional patch
discriminator (counterpart of ``basicsr4rs_tpu/archs/hifacegan_arch.py``;
reference: basicsr/archs/hifacegan_arch.py).

NCHW. The generator's progressive phase is configuration: with
``is_train`` false (the published files) all four up blocks run and the
last ``to_rgbs`` makes the image. ``HiFaceGAN`` encodes its input with the
LIP encoder (``fc`` stays, unused, as in BasicSR's state_dict). The
discriminator returns, a scale, the list of every layer's output, for the
feature-matching loss; its 4x4 convolutions pad 2 on each side.
``JAX_KEY_RULES`` turn the key names ``jax_convert`` gives the JAX
package's modules back into these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import resize_nearest
from .hifacegan_util import (LIPEncoder, SNConv2d, SPADEResnetBlock, avg_pool_3x3s2, batch_norm,
                             instance_norm, nearest_resize_to)


@ARCH_REGISTRY.register()
class SPADEGenerator(nn.Module):

    # jax_convert turns the JAX names head_0, g_middle_0, norm_0, conv_0 into
    # dotted indices; these are module names, not list entries
    JAX_KEY_RULES = ((r'^(head|g_middle)\.(\d)\.', r'\1_\2.'),
                     (r'\.(norm|conv)\.(\d)\.', r'.\1_\2.'))
    scale_ratio = 5   # fixed in the reference too

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, use_vae: bool = False,
                 z_dim: int = 256, crop_size: int = 512,
                 norm_g: str = 'spectralspadesyncbatch3x3', is_train: bool = True,
                 init_train_phase: int = 3):
        super().__init__()
        nf = num_feat
        self.is_train = is_train
        self.train_phase = init_train_phase
        self.fc = nn.Conv2d(num_in_ch, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, norm_g)
        self.ups = nn.ModuleList([SPADEResnetBlock(16 * nf, 8 * nf, norm_g),
                                  SPADEResnetBlock(8 * nf, 4 * nf, norm_g),
                                  SPADEResnetBlock(4 * nf, 2 * nf, norm_g),
                                  SPADEResnetBlock(2 * nf, 1 * nf, norm_g)])
        self.to_rgbs = nn.ModuleList([nn.Conv2d(8 * nf, 3, 3, padding=1),
                                      nn.Conv2d(4 * nf, 3, 3, padding=1),
                                      nn.Conv2d(2 * nf, 3, 3, padding=1),
                                      nn.Conv2d(1 * nf, 3, 3, padding=1)])

    def encode(self, x):
        h, w = x.shape[2:]
        sh, sw = h // 2**self.scale_ratio, w // 2**self.scale_ratio
        return self.fc(nearest_resize_to(x, (sh, sw)))

    def phase(self) -> int:
        return self.train_phase + 1 if self.is_train else 4

    def forward(self, x):
        return self.mixed_guidance_forward(x)

    def mixed_guidance_forward(self, input_x, seg=None, n: int = 0, mode: str = 'progressive'):
        """The forward with a guide a block: ``input_x`` for some, ``seg``
        for the rest, by ``mode`` (progressive: the first ``n``; one_plug:
        only the ``n``-th; one_ablate: all but the ``n``-th). Without
        ``seg``, the plain forward."""
        phase = self.phase()
        blocks = 4 + phase
        if seg is None:
            guides = [input_x] * blocks
        elif mode == 'progressive':
            n = max(min(n, blocks), 0)
            guides = [input_x] * n + [seg] * (blocks - n)
        elif mode == 'one_plug':
            guides = [seg] * blocks
            guides[max(min(n, blocks - 1), 0)] = input_x
        elif mode == 'one_ablate':
            if n > blocks - 1:
                return self(input_x)
            guides = [input_x] * blocks
            guides[n] = seg
        else:
            raise ValueError(f'unknown mode {mode}')
        x = self.encode(guides[0])
        x = self.head_0(x, guides[1])
        x = resize_nearest(x, 2)
        x = self.g_middle_0(x, guides[2])
        x = self.g_middle_1(x, guides[3])
        for i in range(phase):
            x = resize_nearest(x, 2)
            x = self.ups[i](x, guides[4 + i])
        return torch.tanh(self.to_rgbs[phase - 1](F.leaky_relu(x, 0.2)))


@ARCH_REGISTRY.register()
class HiFaceGAN(SPADEGenerator):
    """The SPADE generator on a learnt LIP encoder."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, use_vae: bool = False,
                 z_dim: int = 256, crop_size: int = 512,
                 norm_g: str = 'spectralspadesyncbatch3x3', is_train: bool = True,
                 init_train_phase: int = 3):
        super().__init__(num_in_ch, num_feat, use_vae, z_dim, crop_size, norm_g, is_train,
                         init_train_phase)
        sw = crop_size // 2**self.scale_ratio
        self.lip_encoder = LIPEncoder(num_in_ch, num_feat, sw, sw, self.scale_ratio)

    def encode(self, x):
        return self.lip_encoder(x)


class NLayerDiscriminator(nn.Module):
    """A PatchGAN: a 4x4 stride-2 convolution, ``n_layers_d - 1`` more
    (doubling to 512 features, the last of stride 1; spectral and with the
    ``norm_d`` norm), and a 4x4 one to a map of logits; each followed by a
    leaky ReLU but the last. Returns every stage's output (or the last).
    A ``batch`` norm takes the global batch's statistics in training on
    several ranks (``sync_ranks``), as SPADE's does."""

    sync_ranks = False

    def __init__(self, input_nc: int, n_layers_d: int = 4, num_feat: int = 64,
                 norm_d: str = 'spectralinstance', keep_features: bool = True):
        super().__init__()
        self.n_layers_d = n_layers_d
        self.keep_features = keep_features
        spectral = norm_d.startswith('spectral')
        self.sub_norm = norm_d[len('spectral'):] if spectral else norm_d
        nf = num_feat
        self.model0 = nn.Sequential(nn.Conv2d(input_nc, nf, 4, 2, 2))
        for n in range(1, n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_d - 1 else 2
            conv = (SNConv2d(nf_prev, nf, 4, stride, 2, bias=False) if spectral
                    else nn.Conv2d(nf_prev, nf, 4, stride, 2, bias=False))
            setattr(self, f'model{n}', nn.Sequential(nn.Sequential(conv) if spectral else conv))
        setattr(self, f'model{n_layers_d}', nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))

    def _norm(self, h):
        if self.sub_norm in ('instance', 'sync_batch'):
            return instance_norm(h)
        if self.sub_norm == 'batch':
            return batch_norm(h, sync=self.training and self.sync_ranks)
        return h

    def forward(self, x):
        results = [F.leaky_relu(self.model0(x), 0.2)]
        for n in range(1, self.n_layers_d):
            h = self._norm(getattr(self, f'model{n}')(results[-1]))
            results.append(F.leaky_relu(h, 0.2))
        results.append(getattr(self, f'model{self.n_layers_d}')(results[-1]))
        return results if self.keep_features else results[-1]


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """``num_d`` NLayerDiscriminators on the (conditional: LQ and image)
    input, each scale on the one before it pooled 3x3 / 2 without the
    padding in the count. Returns a list, a scale, of each stage's output."""

    JAX_KEY_RULES = ((r'^discriminator\.(\d+)\.', r'discriminator_\1.'),)

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, conditional_d: bool = True,
                 num_d: int = 2, n_layers_d: int = 4, num_feat: int = 64,
                 norm_d: str = 'spectralinstance', keep_features: bool = True):
        super().__init__()
        self.num_d = num_d
        input_nc = num_in_ch + (num_out_ch if conditional_d else 0)
        for i in range(num_d):
            self.add_module(f'discriminator_{i}', NLayerDiscriminator(
                input_nc, n_layers_d, num_feat, norm_d, keep_features))

    def forward(self, x):
        result = []
        for i in range(self.num_d):
            result.append(getattr(self, f'discriminator_{i}')(x))
            x = avg_pool_3x3s2(x, count_include_pad=False)
        return result
