"""Discriminators: the VGG-style one with BatchNorm and Real-ESRGAN's U-Net
with spectral normalisation (counterpart of
``basicsr4rs_tpu/archs/discriminator_arch.py``; reference:
basicsr/archs/discriminator_arch.py).

Two places where the obvious PyTorch module computes something else than
the JAX package:

* Spectral normalisation is exact and stateless: every forward divides the
  weight by its top singular value, taken from the eigenvalues of its small
  Gram matrix, with the gradient through it. ``torch.nn.utils.spectral_norm``
  keeps a running one-step power iteration, a different function. The
  weight is ``weight_orig`` as in BasicSR's checkpoints; their
  ``weight_u`` and ``weight_v`` are read and dropped.
* The VGG-style discriminator's BatchNorm is ``arch_util.BatchNorm2d``,
  which keeps the batch's *biased* variance in its running variance (Flax's
  ``BatchNorm``; ``nn.BatchNorm2d`` keeps the unbiased one), with Flax's
  momentum 0.9 (0.1 in torch's sense). ``frozen_batch_stats(net)`` runs
  passes in train mode that leave the running statistics as they are: a
  GAN's generator phase, and ESRGAN's constant fake pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
# BatchNorm2d and frozen_batch_stats live in arch_util; both stay importable here
from .arch_util import BatchNorm2d, frozen_batch_stats, resize_bilinear  # noqa: F401


def spectral_normalize(weight: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``weight`` divided by its top singular value, as a matrix of
    (out, in * kh * kw): sigma is the square root of the top eigenvalue of
    the Gram matrix on the smaller side."""
    mat = weight.reshape(weight.shape[0], -1)
    gram = mat @ mat.T if mat.shape[0] <= mat.shape[1] else mat.T @ mat
    sigma = torch.linalg.eigvalsh(gram)[-1].clamp(min=0).sqrt()
    return weight / (sigma + eps)


class SNConv(nn.Module):
    """A ``Conv2d`` whose weight (``weight_orig``) is spectrally normalised
    on every forward."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                                    kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight_orig, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1 / math.sqrt(self.weight_orig[0].numel())
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return F.conv2d(x, spectral_normalize(self.weight_orig), self.bias, self.stride,
                        self.padding)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in ('weight_u', 'weight_v'):   # the power iteration's state
            state_dict.pop(prefix + key, None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator(nn.Module):
    """Conv stages that halve the map down to 4x4 (input 128: 5 stages;
    256: 6), each conv but the first followed by BatchNorm and a
    leaky-ReLU, then two linear layers on the map flattened in NCHW order.
    BasicSR's key names (``conv0_0``, ``bn0_1``, ..., ``linear1``)."""

    # the generic rules turn conv0_0 into conv0.0: turn it back
    JAX_KEY_RULES = ((r'^(conv|bn)(\d+)\.(\d+)\.', r'\1\2_\3.'),)

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, input_size: int = 128):
        super().__init__()
        if input_size not in (128, 256):
            raise ValueError(f'input size must be 128 or 256, but received {input_size}')
        self.input_size = input_size
        self.conv0_0 = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1, bias=True)
        self.conv0_1 = nn.Conv2d(num_feat, num_feat, 4, 2, 1, bias=False)
        self.bn0_1 = BatchNorm2d(num_feat)
        self.num_stages = 4 if input_size == 128 else 5
        cin = num_feat
        for i in range(1, self.num_stages + 1):
            ch = num_feat * min(2**i, 8)
            setattr(self, f'conv{i}_0', nn.Conv2d(cin, ch, 3, 1, 1, bias=False))
            setattr(self, f'bn{i}_0', BatchNorm2d(ch))
            setattr(self, f'conv{i}_1', nn.Conv2d(ch, ch, 4, 2, 1, bias=False))
            setattr(self, f'bn{i}_1', BatchNorm2d(ch))
            cin = ch
        self.linear1 = nn.Linear(cin * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != self.input_size or x.shape[3] != self.input_size:
            raise ValueError(f'Input size must be identical to input_size, but received '
                             f'{tuple(x.shape)}.')
        feat = lrelu(self.conv0_0(x))
        feat = lrelu(self.bn0_1(self.conv0_1(feat)))
        for i in range(1, self.num_stages + 1):
            feat = lrelu(getattr(self, f'bn{i}_0')(getattr(self, f'conv{i}_0')(feat)))
            feat = lrelu(getattr(self, f'bn{i}_1')(getattr(self, f'conv{i}_1')(feat)))
        feat = lrelu(self.linear1(feat.flatten(1)))
        return self.linear2(feat)


@ARCH_REGISTRY.register()
@ARCH_REGISTRY.register(name='UNetDiscriminatorSN_basicsr4rs_tpu')
class UNetDiscriminatorSN(nn.Module):
    """Real-ESRGAN's U-Net discriminator: three stride-2 SN convs down, three
    bilinear x2 upsamplings each followed by an SN conv (skips added), two
    SN convs and a plain one to a map of logits the input's size."""

    # the JAX SNConv's kernel is BasicSR's weight_orig
    JAX_KEY_RULES = ((r'^(conv[1-8])\.weight$', r'\1.weight_orig'),)

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, skip_connection: bool = True):
        super().__init__()
        self.skip_connection = skip_connection
        nf = num_feat
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv(nf, nf * 2, 4, 2, 1, bias=False)
        self.conv2 = SNConv(nf * 2, nf * 4, 4, 2, 1, bias=False)
        self.conv3 = SNConv(nf * 4, nf * 8, 4, 2, 1, bias=False)
        self.conv4 = SNConv(nf * 8, nf * 4, 3, 1, 1, bias=False)
        self.conv5 = SNConv(nf * 4, nf * 2, 3, 1, 1, bias=False)
        self.conv6 = SNConv(nf * 2, nf, 3, 1, 1, bias=False)
        self.conv7 = SNConv(nf, nf, 3, 1, 1, bias=False)
        self.conv8 = SNConv(nf, nf, 3, 1, 1, bias=False)
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def up(v):
            return resize_bilinear(v, v.shape[2] * 2, v.shape[3] * 2)

        x0 = lrelu(self.conv0(x))
        x1 = lrelu(self.conv1(x0))
        x2 = lrelu(self.conv2(x1))
        x3 = lrelu(self.conv3(x2))
        x4 = lrelu(self.conv4(up(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lrelu(self.conv5(up(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lrelu(self.conv6(up(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = lrelu(self.conv7(x6))
        out = lrelu(self.conv8(out))
        return self.conv9(out)
