"""LPIPS, the learned perceptual distance with AlexNet features (counterpart
of ``basicsr4rs_tpu/metrics/lpips.py``; reference: basicsr/metrics/lpips.py,
which calls ``pyiqa``).

The weights are the two standard torch files, torchvision's ``alexnet``
(``features.<i>.weight``/``bias``) and the ``lpips`` package's linear heads
(``lin<i>.model.1.weight``); without them the metric raises
``FileNotFoundError`` and never falls back. The network runs on the card when
there is one, else on the CPU, and is kept per weight files (path and
modification time) and device. ``calculate_lpips_none`` answers -1, the
reference's placeholder."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import METRIC_REGISTRY

# the standardisation of lpips.ScalingLayer
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)

LOCAL_LPIPS_ALEXNET = 'experiments/pretrained_models/alexnet-owt.pth'
LOCAL_LPIPS_LIN = 'experiments/pretrained_models/lpips_alex_v0.1.pth'
# torchvision AlexNet's ``features``: (index, in, out, kernel, stride, padding)
# of each convolution; a ReLU after each, a 3x3 max pool of stride 2 after
# the first two
_ALEX_CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
               (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))


class _AlexFeatures(nn.Module):
    """torchvision AlexNet's ``features`` trunk (keys ``features.<i>``),
    answering the five ReLU outputs LPIPS compares."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict({str(i): nn.Conv2d(cin, cout, k, s, p)
                                       for i, cin, cout, k, s, p in _ALEX_CONVS})

    def forward(self, x):
        taps = []
        for n, (i, *_) in enumerate(_ALEX_CONVS):
            if n in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(self.features[str(i)](x))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """AlexNet-LPIPS: each tap normalised over its channels, the squared
    difference weighted per channel by the ReLU of the linear head
    (``lin<i>``), summed over channels, averaged over the map, summed over
    the taps. Inputs NCHW RGB in [-1, 1]; answers (N,) distances."""

    CHANNELS = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.net = _AlexFeatures()
        self.lin = nn.ParameterList([nn.Parameter(torch.ones(c)) for c in self.CHANNELS])
        self.register_buffer('shift', torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer('scale', torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x, y):
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.
        for ax, ay, w in zip(fx, fy, self.lin):
            ax = ax * torch.rsqrt((ax**2).sum(dim=1, keepdim=True) + 1e-10)
            ay = ay * torch.rsqrt((ay**2).sum(dim=1, keepdim=True) + 1e-10)
            weighted = ((ax - ay)**2 * F.relu(w).view(1, -1, 1, 1)).sum(dim=1)
            total = total + weighted.mean(dim=(1, 2))
        return total


def load_lpips_weights(net: LPIPS, alexnet_path: Optional[str] = None,
                       lin_path: Optional[str] = None) -> LPIPS:
    """Fill ``net`` from torchvision's AlexNet file and the lpips linear
    heads' file. Raises ``FileNotFoundError`` when a file is absent."""
    alexnet_path = alexnet_path or LOCAL_LPIPS_ALEXNET
    lin_path = lin_path or LOCAL_LPIPS_LIN
    for path in (alexnet_path, lin_path):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f'LPIPS weight file missing: {path}. Download torchvision alexnet '
                'weights and lpips alex v0.1 linear weights, then point '
                'load_lpips_weights at them.')
    alex = torch.load(alexnet_path, map_location='cpu', weights_only=True)
    lins = torch.load(lin_path, map_location='cpu', weights_only=True)
    with torch.no_grad():
        for i, *_ in _ALEX_CONVS:
            conv = net.net.features[str(i)]
            conv.weight.copy_(alex[f'features.{i}.weight'])
            conv.bias.copy_(alex[f'features.{i}.bias'])
        for i, w in enumerate(net.lin):
            w.copy_(lins[f'lin{i}.model.1.weight'].reshape(-1))
    return net


_EVALUATORS = {}


def _evaluator(alexnet_path: Optional[str] = None, lin_path: Optional[str] = None) -> LPIPS:
    """The network of these weight files on the device the metric runs on,
    made once per file pair (path and modification time) and device."""
    paths = [p or default for p, default in ((alexnet_path, LOCAL_LPIPS_ALEXNET),
                                             (lin_path, LOCAL_LPIPS_LIN))]
    device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    key = tuple((os.path.abspath(p), os.stat(p).st_mtime_ns if os.path.exists(p) else None)
                for p in paths) + (device,)
    if key not in _EVALUATORS:
        _EVALUATORS[key] = load_lpips_weights(LPIPS(), *paths).to(device).eval()
    return _EVALUATORS[key]


def compute_lpips_score(img: np.ndarray, img2: np.ndarray, **kwargs) -> float:
    """LPIPS between two (H, W) single-band images in [0, 255]: each band
    repeated as R, G and B and scaled to [-1, 1]."""
    assert img.ndim == 2 and img2.ndim == 2, 'inputs must be (H, W) single-band images'
    net = _evaluator(kwargs.get('alexnet_path'), kwargs.get('lin_path'))
    device = net.shift.device

    def rgb(a):
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        return (t / 255.0 * 2 - 1).expand(1, 3, *a.shape)

    with torch.inference_mode():
        return float(net(rgb(img), rgb(img2))[0])


@METRIC_REGISTRY.register()
def calculate_lpips_band(img, img2, crop_border, band, input_order='HWC', **kwargs):
    """LPIPS of one band of two images, after cropping ``crop_border``
    pixels from each side. ``alexnet_path`` and ``lin_path`` may name the
    weight files."""
    assert img.shape == img2.shape, f'Image shapes are different: {img.shape}, {img2.shape}.'
    if input_order == 'HWC':
        assert band < img.shape[2]
        img_band, img2_band = img[:, :, band], img2[:, :, band]
    elif input_order == 'CHW':
        assert band < img.shape[0]
        img_band, img2_band = img[band], img2[band]
    else:
        raise ValueError(f'Wrong input_order {input_order}. Supported input_orders are "HWC" and "CHW".')
    if crop_border > 0:
        img_band = img_band[crop_border:-crop_border, crop_border:-crop_border]
        img2_band = img2_band[crop_border:-crop_border, crop_border:-crop_border]
    return compute_lpips_score(img_band, img2_band, **kwargs)


@METRIC_REGISTRY.register()
def calculate_lpips_none(**kwargs):
    """The reference's placeholder: -1, whatever the images."""
    return -1
