"""VGG feature extractor for the perceptual losses (counterpart of
``basicsr4rs_tpu/archs/vgg_arch.py``; reference: basicsr/archs/vgg_arch.py).

Weights: a torchvision-format ``.pth`` (``features.<index>.weight``), read
from ``pretrain_path``, else ``$BASICSR4RS_TPU_VGG19_PATH`` (the JAX
package's variable, read the same way), else
``experiments/pretrained_models/vgg19-dcbb9e9d.pth``. Nothing is downloaded:
when the file is absent the extractor logs a warning and keeps a random
initialisation drawn from a seed-0 generator, as the JAX package does; the
feature shapes and the loss plumbing stay exact, the numbers need the file.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..utils.logger import get_root_logger
from ..utils.registry import ARCH_REGISTRY
from .arch_util import default_conv_init_

VGG_DEFAULT_PATH = 'experiments/pretrained_models/vgg19-dcbb9e9d.pth'

# channels of each conv, 'M' a max-pool (torchvision's configurations)
_CFG = {
    'vgg11': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'vgg13': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'vgg16': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512, 'M', 512, 512, 512,
              'M'],
    'vgg19': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512, 512, 512, 'M',
              512, 512, 512, 512, 'M'],
}


def vgg_layer_names(vgg_type: str) -> List[str]:
    """The layer names of a VGG's ``features`` in order (``conv1_1``,
    ``relu1_1``, ..., ``pool1``, ...): index i is torchvision's
    ``features.<i>``."""
    names, block, conv = [], 1, 1
    for v in _CFG[vgg_type]:
        if v == 'M':
            names.append(f'pool{block}')
            block, conv = block + 1, 1
        else:
            names += [f'conv{block}_{conv}', f'relu{block}_{conv}']
            conv += 1
    return names


def vgg_weights_path(pretrain_path: Optional[str] = None) -> str:
    """The VGG weights file the extractor reads (see the module's doc)."""
    return pretrain_path or os.environ.get('BASICSR4RS_TPU_VGG19_PATH', VGG_DEFAULT_PATH)


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """The outputs of the named layers (e.g. ``['conv5_4']``) of a VGG's
    feature stack, deepest needed layer last; ``vgg_net`` holds the layers
    under their names. ``use_input_norm`` normalises the input by
    ImageNet's mean and std, after ``range_norm`` maps [-1, 1] to [0, 1].
    ``remove_pooling`` drops the max-pools, ``pooling_stride`` sets their
    stride. Frozen unless ``requires_grad``."""

    JAX_KEY_RULES = ((r'^conv(\d+)\.(\d+)\.', r'vgg_net.conv\1_\2.'),)

    def __init__(self, layer_name_list: Sequence[str], vgg_type: str = 'vgg19',
                 use_input_norm: bool = True, range_norm: bool = False,
                 requires_grad: bool = False, remove_pooling: bool = False,
                 pooling_stride: int = 2, pretrain_path: Optional[str] = None):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = vgg_layer_names(vgg_type)
        depth = max(names.index(v) for v in self.layer_name_list) + 1
        channels = iter([c for c in _CFG[vgg_type] if c != 'M'])
        layers, cin = OrderedDict(), 3
        for name in names[:depth]:
            if name.startswith('conv'):
                cout = next(channels)
                layers[name] = nn.Conv2d(cin, cout, 3, 1, 1)
                cin = cout
            elif name.startswith('relu'):
                layers[name] = nn.ReLU()
            elif not remove_pooling:
                layers[name] = nn.MaxPool2d(kernel_size=2, stride=pooling_stride)
        self.vgg_net = nn.Sequential(layers)
        self.register_buffer('mean', torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)
        load_vgg_params(self, pretrain_path)
        if not requires_grad:
            self.vgg_net.eval()
            for p in self.parameters():
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        outputs = {}
        for name, layer in self.vgg_net.named_children():
            x = layer(x)
            if name in self.layer_name_list:
                outputs[name] = x
        return outputs


@torch.no_grad()
def load_vgg_params(extractor: VGGFeatureExtractor, pretrain_path: Optional[str] = None) -> bool:
    """Fill the extractor's convolutions from a torchvision-format ``.pth``
    (``features.<index>.weight`` / ``.bias``); without the file, a seed-0
    random initialisation and a warning. Returns whether the file was read."""
    path = vgg_weights_path(pretrain_path)
    convs = {name: m for name, m in extractor.vgg_net.named_children()
             if isinstance(m, nn.Conv2d)}
    if not os.path.isfile(path):
        generator = torch.Generator().manual_seed(0)
        for conv in convs.values():
            default_conv_init_(conv, generator)
        get_root_logger().warning(f'VGG pretrained weights not found at {path}; using random '
                                  'init: perceptual-loss numerics will not match the reference.')
        return False
    state = torch.load(path, map_location='cpu', weights_only=True)
    names = vgg_layer_names(extractor.vgg_type)
    for key, value in state.items():
        parts = key.split('.')
        if parts[0] != 'features' or len(parts) != 3:
            continue
        conv = convs.get(names[int(parts[1])] if int(parts[1]) < len(names) else None)
        if conv is not None:
            getattr(conv, parts[2]).copy_(value)
    get_root_logger().info(f'VGG weights loaded from {path}')
    return True
