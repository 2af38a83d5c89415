"""TOFlow, task-oriented flow video SR (counterpart of
``basicsr4rs_tpu/archs/tof_arch.py``; reference: basicsr/archs/tof_arch.py).
NCHW; clips (N, 7, 3, H, W) already upsampled to the output's size;
BasicSR's module and key layout.

A four-level SpyNet with BatchNorm aligns each support frame to the
reference frame (each level warps by ``flow_warp``: one launch of the
sampler kernel), and four convolutions fuse the seven aligned frames, in
ImageNet-normalised space. In training the flow network runs once per
support frame, as BasicSR does, so that its BatchNorms see one frame's batch
each; in eval mode (running statistics) the six support frames are folded
into the batch and aligned in one call, as in the JAX package. The
BatchNorms keep Flax's running statistics (``arch_util.BatchNorm2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import BatchNorm2d, flow_warp, resize_bilinear


class BasicModule(nn.Module):
    """Four (7x7 conv without bias, BatchNorm, ReLU) and a 7x7 conv to the
    flow residual, 8 -> 32 -> 64 -> 32 -> 16 -> 2 channels."""

    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16)):
            layers += [nn.Conv2d(cin, cout, 7, 1, 3, bias=False), BatchNorm2d(cout),
                       nn.ReLU(inplace=True)]
        self.basic_module = nn.Sequential(*layers, nn.Conv2d(16, 2, 7, 1, 3))

    def forward(self, x):
        return self.basic_module(x)


class SPyNetTOF(nn.Module):
    """The flow (N, 2, H, W) from ``ref`` to ``supp``, both (N, 3, H, W)
    normalised, H and W multiples of 16: 4 levels of average-pooled images,
    coarse to fine."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(4)])

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], kernel_size=2, stride=2))
            supps.insert(0, F.avg_pool2d(supps[0], kernel_size=2, stride=2))
        flow = ref.new_zeros(n, 2, h // 16, w // 16)
        for i in range(4):
            flow_up = resize_bilinear(flow, 2 * flow.shape[2], 2 * flow.shape[3],
                                      align_corners=True) * 2.0
            warped = flow_warp(supps[i], flow_up.permute(0, 2, 3, 1))
            flow = flow_up + self.basic_module[i](torch.cat([refs[i], warped, flow_up], dim=1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    """(N, 7, 3, H, W) frames in [0, 1], upsampled to the output's size, H
    and W multiples of 16 -> the reference frame (N, 3, H, W). The reference
    is frame 3, or frame 0 with ``adapt_official_weights``, whose frames are
    reordered (3, 0, 1, 2, 4, 5, 6) first."""

    # the general rules turn conv_1 into conv.1: turn it back
    JAX_KEY_RULES = ((r'^conv\.(\d)\.', r'conv_\1.'),)

    def __init__(self, adapt_official_weights: bool = False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        # constants, outside the state_dict (BasicSR stores them)
        self.register_buffer('mean', torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)
        self.spynet = SPyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, 1, 4)
        self.conv_2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        b, t, c, h, w = lrs.shape
        lrs = (lrs - self.mean.unsqueeze(1)) / self.std.unsqueeze(1)
        lr_ref = lrs[:, self.ref_idx]
        supp_idx = [i for i in range(t) if i != self.ref_idx]
        if self.training:   # per support frame: its own BatchNorm batch
            warped = []
            for i in supp_idx:
                flow = self.spynet(lr_ref, lrs[:, i])
                warped.append(flow_warp(lrs[:, i], flow.permute(0, 2, 3, 1)))
        else:   # the support frames folded into the batch: one alignment
            supp = lrs[:, supp_idx].transpose(0, 1).reshape(-1, c, h, w)
            flow = self.spynet(lr_ref.repeat(t - 1, 1, 1, 1), supp)
            warped = flow_warp(supp, flow.permute(0, 2, 3, 1)).view(t - 1, b, c, h, w).unbind(0)
        aligned = list(warped)
        aligned.insert(self.ref_idx, lr_ref)
        hr = torch.stack(aligned, dim=1).view(b, t * c, h, w)
        hr = F.relu(self.conv_1(hr))
        hr = F.relu(self.conv_2(hr))
        hr = F.relu(self.conv_3(hr))
        hr = self.conv_4(hr) + lr_ref
        return hr * self.std + self.mean
