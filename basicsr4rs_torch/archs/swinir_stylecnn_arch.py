"""SwinIR + StyleCNN, a network of two branches (counterpart of
``basicsr4rs_tpu/archs/swinir_stylecnn_arch.py``, which reconstructs it from
the HM training contract: the reference configs name it, the reference tree
lacks it). SwinIR predicts in the histogram-matched domain, closest to the
Landsat input radiometrically, and a small residual CNN maps that prediction
into the Sentinel domain: ``{'hm': sr_net(x), 'gt': style_net(sr_net(x))}``.
Key names follow the JAX module (``sr_net.*``, ``style_net.conv_*``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import default_conv_init_
from .swinir_arch import SwinIR


class StyleCNN(nn.Module):
    """Three 3x3 convolutions with leaky-ReLU (0.2) between them, added to
    the input when the channel counts match."""

    def __init__(self, in_chans: int = 6, out_chans: int = 6, num_feat: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.residual = in_chans == out_chans
        self.conv_first = nn.Conv2d(in_chans, num_feat, 3, 1, 1)
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, out_chans, 3, 1, 1)
        with torch.no_grad():
            for m in (self.conv_first, self.conv_body, self.conv_last):
                default_conv_init_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_first(x), 0.2)
        h = F.leaky_relu(self.conv_body(h), 0.2)
        h = self.conv_last(h)
        return x + h if self.residual else h


@ARCH_REGISTRY.register()
class SwinIR_StyleCNN(nn.Module):

    # JAX package parameter path -> key, SwinIR's rules under ``sr_net``
    JAX_KEY_RULES = (
        (r'^sr_net\.patch_embed_norm\.', 'sr_net.patch_embed.norm.'),
        (r'^sr_net\.upsample\.conv(\d+)\.', lambda m: f'sr_net.upsample.{2 * int(m.group(1))}.'),
    )

    def __init__(self, sr_net_args: dict, style_net_args: dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sr_net = SwinIR(**sr_net_args, generator=generator)
        self.style_net = StyleCNN(**style_net_args, generator=generator)

    @property
    def drop_path_generator(self) -> Optional[torch.Generator]:
        return self.sr_net.drop_path_generator

    def seed_drop_path(self, seed: int, device='cpu') -> torch.Generator:
        return self.sr_net.seed_drop_path(seed, device)

    def forward(self, x: torch.Tensor) -> dict:
        hm = self.sr_net(x)
        return {'hm': hm, 'gt': self.style_net(hm)}
