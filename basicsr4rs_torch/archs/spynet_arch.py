"""SpyNet optical flow: a six-level coarse-to-fine pyramid (counterpart of
``basicsr4rs_tpu/archs/spynet_arch.py``; reference:
basicsr/archs/spynet_arch.py). NCHW in, flow (N, 2, H, W) out with channel 0
the horizontal displacement, as BasicSR has it."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import flow_warp, resize_bilinear


class BasicModule(nn.Module):
    """Five 7x7 convolutions, 8 -> 32 -> 64 -> 32 -> 16 -> 2 channels."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.Sequential(
            nn.Conv2d(8, 32, 7, 1, 3), nn.ReLU(inplace=False),
            nn.Conv2d(32, 64, 7, 1, 3), nn.ReLU(inplace=False),
            nn.Conv2d(64, 32, 7, 1, 3), nn.ReLU(inplace=False),
            nn.Conv2d(32, 16, 7, 1, 3), nn.ReLU(inplace=False),
            nn.Conv2d(16, 2, 7, 1, 3))

    def forward(self, x):
        return self.basic_module(x)


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    """The flow from ``ref`` to ``supp``, both (N, 3, H, W) in [0, 1]: the
    images are resized to multiples of 32, each level warps ``supp`` by the
    upsampled flow (one launch of the sampler kernel, ``border`` padding)
    and refines it. ``load_path``: a ``.pth`` of pretrained weights. The
    normalisation constants are buffers outside the ``state_dict``."""

    JAX_KEY_RULES = ()   # the general rules of utils.jax_convert suffice

    def __init__(self, load_path=None):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(6)])
        if load_path:
            state = torch.load(load_path, map_location='cpu', weights_only=True)
            self.load_state_dict(state.get('params', state))
        self.register_buffer('mean', torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, ref, supp):
        if ref.shape != supp.shape:
            raise ValueError(f'SpyNet: ref {tuple(ref.shape)} and supp {tuple(supp.shape)} differ')
        n, _, h, w = ref.shape
        w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
        h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
        refs = [(resize_bilinear(ref, h_floor, w_floor) - self.mean) / self.std]
        supps = [(resize_bilinear(supp, h_floor, w_floor) - self.mean) / self.std]
        for _ in range(5):
            refs.insert(0, F.avg_pool2d(refs[0], kernel_size=2, stride=2,
                                        count_include_pad=False))
            supps.insert(0, F.avg_pool2d(supps[0], kernel_size=2, stride=2,
                                         count_include_pad=False))

        flow = ref.new_zeros(n, 2, refs[0].shape[2] // 2, refs[0].shape[3] // 2)
        for level in range(6):
            upsampled_flow = resize_bilinear(flow, 2 * flow.shape[2], 2 * flow.shape[3],
                                             align_corners=True) * 2.0
            if upsampled_flow.shape[2] != refs[level].shape[2]:
                upsampled_flow = F.pad(upsampled_flow, [0, 0, 0, 1], mode='replicate')
            if upsampled_flow.shape[3] != refs[level].shape[3]:
                upsampled_flow = F.pad(upsampled_flow, [0, 1, 0, 0], mode='replicate')
            warped = flow_warp(supps[level], upsampled_flow.permute(0, 2, 3, 1),
                               interpolation='bilinear', padding_mode='border')
            flow = self.basic_module[level](
                torch.cat([refs[level], warped, upsampled_flow], dim=1)) + upsampled_flow

        flow = resize_bilinear(flow, h, w)
        scale = flow.new_tensor([w / w_floor, h / h_floor]).view(1, 2, 1, 1)
        return flow * scale
