"""DFDNet: face restoration with a dictionary of facial components
(counterpart of ``basicsr4rs_tpu/archs/dfdnet_arch.py``; reference:
basicsr/archs/dfdnet_arch.py).

NCHW, BasicSR's key names. A VGG19 reads four feature levels of the 512x512
face; at each level each part (left eye, right eye, nose, mouth) is
cropped by its box, the dictionary's entries of that part are re-normalised
to the crop's statistics (AdaIN), the entry most like the crop (softmax of
the dot products, its argmax) is resized into the box, and an attention
block blends it in; an MSDilation block and four SFT up blocks decode.

The swap runs on the device: the boxes are host integers (``location //
(512 // size)``), the selected entry stays a device index (no copy to the
host), kept in ``selected`` for a caller to read. The dictionary
(``load_dfdnet_dict``) is ``{size: {part: (N, C, h, w)}}``, numpy or
tensors; it is passed to each call, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .dfdnet_util import AttentionBlock, Blur, MSDilationBlock, UpResBlock, \
    adaptive_instance_normalization
from .hifacegan_util import SNConv2d, nearest_resize_to
from .vgg_arch import VGGFeatureExtractor


def load_dfdnet_dict(dict_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The facial-component dictionary of a ``.pth`` (``{size: {part:
    (N, C, h, w)}}``) as NCHW numpy."""
    d = torch.load(dict_path, map_location='cpu', weights_only=True)
    return {str(k): {kk: vv.numpy() for kk, vv in v.items()} for k, v in d.items()}


def select_entry(part: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """The index (1,) of the entry (N, C, h, w) most like ``part`` (C, h,
    w): the argmax of the softmax of their dot products (a VALID
    convolution of the crop with each entry). The entries come through
    AdaIN with the crop's per-channel means, so every dot product holds
    the same large term, sum over c of h * w * mean_c^2: at conv5_4 it is
    10^5 against differences of 10^-1, below float32's rounding of the
    sum. The products are taken with the crop's means removed (the
    softmax drops a common term) and in float64, so that the card and the
    CPU pick the same entry."""
    centred = part - part.mean(dim=(1, 2), keepdim=True)
    similarity = torch.einsum('chw,nchw->n', centred.double(), entries.double())
    return torch.argmax(F.softmax(similarity, dim=0)).reshape(1)


class SFTUpBlock(nn.Module):
    """Blur and a spectral convolution, scaled and shifted by two
    convolution branches of the swapped features (spatial feature
    transform), bilinear x2, a spectral convolution."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(Blur(), SNConv2d(in_channel, out_channel, kernel_size, 1,
                                                    padding),
                                   nn.LeakyReLU(0.04))   # two stacked 0.2-lrelus officially
        self.convup = nn.Sequential(nn.Upsample(scale_factor=2, mode='bilinear',
                                                align_corners=False),
                                    SNConv2d(out_channel, out_channel, kernel_size, 1, padding),
                                    nn.LeakyReLU(0.2))
        self.scale_block = nn.Sequential(SNConv2d(in_channel, out_channel, 3, 1, 1),
                                         nn.LeakyReLU(0.2),
                                         SNConv2d(out_channel, out_channel, 3, 1, 1))
        self.shift_block = nn.Sequential(SNConv2d(in_channel, out_channel, 3, 1, 1),
                                         nn.LeakyReLU(0.2),
                                         SNConv2d(out_channel, out_channel, 3, 1, 1), nn.Sigmoid())

    def forward(self, x, updated_feat):
        out = self.conv1(x)
        out = out * self.scale_block(updated_feat) + self.shift_block(updated_feat)
        return self.convup(out)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):

    parts = ('left_eye', 'right_eye', 'nose', 'mouth')
    feature_sizes = (256, 128, 64, 32)
    channel_sizes = (128, 256, 512, 512)
    vgg_layers = ('relu2_2', 'relu3_4', 'relu4_4', 'conv5_4')
    # jax_convert splits the JAX names left_eye_256_0 and conv1_1 into
    # indices; the JAX VGG extractor is flat (no vgg_net)
    JAX_KEY_RULES = ((r'^attn_blocks\.(\w+?)\.(\d+)\.(\d)\.', r'attn_blocks.\1_\2.\3.'),
                     (r'^vgg_extractor\.conv(\d)\.(\d)\.', r'vgg_extractor.vgg_net.conv\1_\2.'))

    def __init__(self, num_feat: int, dict_path: str = ''):
        super().__init__()
        self.vgg_extractor = VGGFeatureExtractor(layer_name_list=list(self.vgg_layers),
                                                 vgg_type='vgg19', use_input_norm=True,
                                                 range_norm=True, requires_grad=False)
        self.attn_blocks = nn.ModuleDict()
        for ch, f_size in zip(self.channel_sizes, self.feature_sizes):
            for part in self.parts:
                self.attn_blocks[f'{part}_{f_size}'] = AttentionBlock(ch)
        self.multi_scale_dilation = MSDilationBlock(num_feat * 8, dilation=(4, 3, 2, 1))
        self.upsample0 = SFTUpBlock(num_feat * 8, num_feat * 8)
        self.upsample1 = SFTUpBlock(num_feat * 8, num_feat * 4)
        self.upsample2 = SFTUpBlock(num_feat * 4, num_feat * 2)
        self.upsample3 = SFTUpBlock(num_feat * 2, num_feat)
        self.upsample4 = nn.Sequential(SNConv2d(num_feat, num_feat, 3, 1, 1), nn.LeakyReLU(0.2),
                                       UpResBlock(num_feat), UpResBlock(num_feat),
                                       nn.Conv2d(num_feat, 3, 3, 1, 1), nn.Tanh())
        self.selected: List[torch.Tensor] = []

    def swap_feat(self, vgg_feat, updated_feat, dict_feat, location, part_name, f_size):
        """``updated_feat`` with the box ``location`` (host ints x0, y0, x1,
        y1) of sample 0 replaced by the blended best dictionary entry."""
        x0, y0, x1, y1 = (int(v) for v in location)
        part_feat = vgg_feat[:, :, y0:y1, x0:x1]
        part_resize_feat = F.interpolate(part_feat, size=dict_feat.shape[2:], mode='bilinear',
                                         align_corners=False)
        dict_feat = adaptive_instance_normalization(dict_feat, part_resize_feat)
        select_idx = select_entry(part_resize_feat[0], dict_feat)
        self.selected.append(select_idx)
        swap_feat = nearest_resize_to(dict_feat.index_select(0, select_idx), (y1 - y0, x1 - x0))
        attn = self.attn_blocks[f'{part_name}_{f_size}'](swap_feat - part_feat)
        updated_feat = updated_feat.clone()
        updated_feat[:, :, y0:y1, x0:x1] = attn * swap_feat + part_feat
        return updated_feat

    def forward(self, x, part_locations: Optional[Sequence] = None, dictionary=None):
        """``x``: (1, 3, 512, 512) in [-1, 1]; ``part_locations``: per part a
        (b, 4) box (x0, y0, x1, y1) at 512; ``dictionary``: as
        ``load_dfdnet_dict`` gives it. Without boxes, no swap."""
        vgg_features = self.vgg_extractor(x)
        self.selected = []
        updated = []
        for vgg_layer, f_size in zip(self.vgg_layers, self.feature_sizes):
            vgg_feat = updated_feat = vgg_features[vgg_layer]
            if part_locations is not None:
                for part_idx, part_name in enumerate(self.parts):
                    location = np.asarray(part_locations[part_idx][0]) // (512 // f_size)
                    dict_feat = torch.as_tensor(dictionary[f'{f_size}'][part_name],
                                                device=x.device, dtype=x.dtype)
                    updated_feat = self.swap_feat(vgg_feat, updated_feat, dict_feat, location,
                                                  part_name, f_size)
            updated.append(updated_feat)
        feat = self.multi_scale_dilation(vgg_features['conv5_4'])
        feat = self.upsample0(feat, updated[3])
        feat = self.upsample1(feat, updated[2])
        feat = self.upsample2(feat, updated[1])
        feat = self.upsample3(feat, updated[0])
        return self.upsample4(feat)
