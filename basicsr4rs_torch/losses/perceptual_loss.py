"""Perceptual (VGG feature) loss (counterpart of
``basicsr4rs_tpu/losses/perceptual_loss.py``; reference:
basicsr/losses/basic_loss.py ``PerceptualLoss``).

The output's and the target's features at ``layer_weights``' layers of a
frozen VGG (``archs/vgg_arch.py``), compared by ``criterion`` (``l1``,
``l2``/``mse``: means; ``fro``: one Frobenius norm over the whole
difference), and optionally their Gram matrices (the style loss). The
target's features are computed without gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..archs.vgg_arch import VGGFeatureExtractor
from ..utils.registry import LOSS_REGISTRY


def gram(x: torch.Tensor) -> torch.Tensor:
    """Gram matrix of (N, C, H, W) features over the pixels, / (C H W)."""
    n, c, h, w = x.shape
    feat = x.reshape(n, c, h * w)
    return torch.bmm(feat, feat.transpose(1, 2)) / (c * h * w)


@LOSS_REGISTRY.register()
class PerceptualLoss(nn.Module):

    def __init__(self, layer_weights: Dict[str, float], vgg_type: str = 'vgg19',
                 use_input_norm: bool = True, range_norm: bool = False,
                 perceptual_weight: float = 1.0, style_weight: float = 0.,
                 criterion: str = 'l1', pretrain_path: Optional[str] = None):
        super().__init__()
        if criterion not in ('l1', 'l2', 'mse', 'fro'):
            raise NotImplementedError(f'{criterion} criterion has not been supported.')
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion_type = criterion
        self.vgg = VGGFeatureExtractor(layer_name_list=list(self.layer_weights), vgg_type=vgg_type,
                                       use_input_norm=use_input_norm, range_norm=range_norm,
                                       pretrain_path=pretrain_path)

    def criterion(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.criterion_type == 'l1':
            return (a - b).abs().mean()
        if self.criterion_type in ('l2', 'mse'):
            return ((a - b)**2).mean()
        return torch.linalg.vector_norm(a - b)

    def forward(self, x: torch.Tensor, gt: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(perceptual loss, style loss); either is None at weight 0. Clips
        (N, T, C, H, W) go through the VGG as N * T images: the means are
        those of the JAX package, whose convolutions take the leading axes
        as the batch."""
        if x.dim() == 5:
            x, gt = x.flatten(0, 1), gt.flatten(0, 1)
        x_features = self.vgg(x)
        with torch.no_grad():
            gt_features = self.vgg(gt.detach())
        percep_loss = style_loss = None
        if self.perceptual_weight > 0:
            percep_loss = sum(self.criterion(x_features[k], gt_features[k]) * self.layer_weights[k]
                              for k in x_features) * self.perceptual_weight
        if self.style_weight > 0:
            style_loss = sum(self.criterion(gram(x_features[k]), gram(gt_features[k]))
                             * self.layer_weights[k] for k in x_features) * self.style_weight
        return percep_loss, style_loss
