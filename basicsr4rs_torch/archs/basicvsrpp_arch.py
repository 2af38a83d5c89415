"""BasicVSR++: second-order grid propagation with deformable alignment on top
of optical flow (counterpart of ``basicsr4rs_tpu/archs/basicvsrpp_arch.py``;
reference: basicsr/archs/basicvsrpp_arch.py). NCHW; clips (N, T, C, H, W);
BasicSR's module and key layout.

The JAX package scans one propagation step over the frames and masks the
first two steps; here the propagation is a Python loop with BasicSR's
``if i > 0`` / ``if i > 1``, which computes the same values. Both flow
directions come from one SpyNet call on the doubled batch, as in the JAX
package; BasicSR's ``cpu_cache`` offloading and its shortcut for mirrored
clips are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import modulated_deform_conv
from ..utils.registry import ARCH_REGISTRY
from .arch_util import flow_warp
from .basicvsr_arch import ConvResidualBlocks, bidirectional_flows
from .spynet_arch import SpyNet


class SecondOrderDeformableAlignment(nn.Module):
    """A deformable convolution of the two previous propagated features,
    whose offsets are residuals (at most ``max_residue_magnitude``) on top of
    the two optical flows."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.):
        super().__init__()
        self.padding, self.deformable_groups = padding, deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        stdv = 1. / math.sqrt(in_channels * k * k)
        nn.init.uniform_(self.weight, -stdv, stdv)
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * out_channels + 4, out_channels, 3, 1, 1),
            nn.LeakyReLU(negative_slope=0.1, inplace=False),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1),
            nn.LeakyReLU(negative_slope=0.1, inplace=False),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1),
            nn.LeakyReLU(negative_slope=0.1, inplace=False),
            nn.Conv2d(out_channels, 27 * deformable_groups, 3, 1, 1))
        nn.init.zeros_(self.conv_offset[-1].weight)
        nn.init.zeros_(self.conv_offset[-1].bias)

    def forward(self, x, extra_feat, flow_1, flow_2):
        """x (N, 2C, H, W); extra_feat (N, 3C, H, W); flows (N, 2, H, W),
        channel 0 horizontal."""
        out = self.conv_offset(torch.cat([extra_feat, flow_1, flow_2], dim=1))
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat((o1, o2), dim=1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        # offsets are (dy, dx) per tap: the flows flipped and repeated
        offset_1 = offset_1 + flow_1.flip(1).repeat(1, offset_1.size(1) // 2, 1, 1)
        offset_2 = offset_2 + flow_2.flip(1).repeat(1, offset_2.size(1) // 2, 1, 1)
        offset = torch.cat([offset_1, offset_2], dim=1)
        return modulated_deform_conv(x, offset, torch.sigmoid(mask), self.weight, self.bias,
                                     stride=1, padding=self.padding,
                                     deform_groups=self.deformable_groups)


@ARCH_REGISTRY.register()
class BasicVSRPlusPlus(nn.Module):
    """Clips (N, T, 3, H, W) in, (N, T, 3, 4H, 4W) out (or (N, T, 3, H, W)
    with ``is_low_res_input: false``, where the input is at the output's size
    and the propagation runs on a quarter of it)."""

    # Flax scope names -> BasicSR keys: the scanned step's scope
    # prop_<branch>.{deform_align, backbone} is BasicSR's ModuleDict entry
    JAX_KEY_RULES = (
        (r'prop_(backward|forward)\.(\d)\.(deform_align|backbone)\.', r'\3.\1_\2.'),)

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10., is_low_res_input: bool = True,
                 spynet_path: Optional[str] = None, cpu_cache_length: int = 100):
        super().__init__()
        self.mid_channels = mid_channels
        self.is_low_res_input = is_low_res_input
        del cpu_cache_length   # sequences stay on the device

        self.spynet = SpyNet(spynet_path)
        if is_low_res_input:
            self.feat_extract = ConvResidualBlocks(3, mid_channels, 5)
        else:
            self.feat_extract = nn.Sequential(
                nn.Conv2d(3, mid_channels, 3, 2, 1),
                nn.LeakyReLU(negative_slope=0.1, inplace=False),
                nn.Conv2d(mid_channels, mid_channels, 3, 2, 1),
                nn.LeakyReLU(negative_slope=0.1, inplace=False),
                ConvResidualBlocks(mid_channels, mid_channels, 5))

        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        self.branches = ['backward_1', 'forward_1', 'backward_2', 'forward_2']
        for i, module in enumerate(self.branches):
            self.deform_align[module] = SecondOrderDeformableAlignment(
                2 * mid_channels, mid_channels, 3, padding=1, deformable_groups=16,
                max_residue_magnitude=max_residue_magnitude)
            self.backbone[module] = ConvResidualBlocks((2 + i) * mid_channels, mid_channels,
                                                       num_blocks)

        self.reconstruction = ConvResidualBlocks(5 * mid_channels, mid_channels, 5)
        self.upconv1 = nn.Conv2d(mid_channels, mid_channels * 4, 3, 1, 1, bias=True)
        self.upconv2 = nn.Conv2d(mid_channels, 64 * 4, 3, 1, 1, bias=True)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        # in place, as BasicSR's: the head runs every frame at 4x at once, and
        # an activation's own output was a third HR tensor at its peak
        self.lrelu = nn.LeakyReLU(negative_slope=0.1, inplace=True)

    def compute_flow(self, lqs):
        """(flows_forward, flows_backward), each (N, T-1, 2, H, W), from one
        SpyNet call on both directions."""
        return bidirectional_flows(self.spynet, lqs)

    def propagate(self, feats, flows, module_name):
        """One branch: walk the frames (backwards for a ``backward`` branch),
        align the two previous propagated features to the current frame and
        refine; appends the branch's features to ``feats`` in frame order."""
        n, t, _, h, w = flows.shape
        frame_idx = list(range(0, t + 1))
        flow_idx = list(range(-1, t))
        mapping_idx = list(range(0, len(feats['spatial'])))
        mapping_idx += mapping_idx[::-1]
        if 'backward' in module_name:
            frame_idx = frame_idx[::-1]
            flow_idx = frame_idx

        feat_prop = flows.new_zeros(n, self.mid_channels, h, w)
        for i, idx in enumerate(frame_idx):
            feat_current = feats['spatial'][mapping_idx[idx]]
            if i > 0:   # second-order deformable alignment
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = feats[module_name][-2]
                    flow_n2 = flows[:, flow_idx[i - 1]]
                    flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1.permute(0, 2, 3, 1))
                    cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
                cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
                feat_prop = torch.cat([feat_prop, feat_n2], dim=1)
                feat_prop = self.deform_align[module_name](feat_prop, cond, flow_n1, flow_n2)

            feat = [feat_current] + [feats[k][idx] for k in feats
                                     if k not in ('spatial', module_name)] + [feat_prop]
            feat_prop = feat_prop + self.backbone[module_name](torch.cat(feat, dim=1))
            feats[module_name].append(feat_prop)

        if 'backward' in module_name:
            feats[module_name] = feats[module_name][::-1]
        return feats

    def upsample(self, lqs, feats):
        n, t, c, h, w = lqs.shape
        hr = torch.cat([torch.stack(feats[k], dim=1) for k in ['spatial'] + self.branches],
                       dim=2)
        hr = self.reconstruction(hr.reshape(n * t, *hr.shape[2:]))
        hr = self.lrelu(self.pixel_shuffle(self.upconv1(hr)))
        hr = self.lrelu(self.pixel_shuffle(self.upconv2(hr)))
        hr = self.conv_last(self.lrelu(self.conv_hr(hr)))
        base = lqs.reshape(n * t, c, h, w)
        if self.is_low_res_input:
            base = F.interpolate(base, scale_factor=4, mode='bilinear', align_corners=False)
        return (hr + base).view(n, t, *hr.shape[1:])

    def forward(self, lqs):
        n, t, c, h, w = lqs.shape
        if self.is_low_res_input:
            lqs_downsample = lqs
        else:
            lqs_downsample = F.interpolate(lqs.reshape(-1, c, h, w), scale_factor=0.25,
                                           mode='bicubic').view(n, t, c, h // 4, w // 4)
        dh, dw = lqs_downsample.shape[-2:]
        if dh < 64 or dw < 64:
            raise ValueError('The height and width of low-res inputs must be at least 64, '
                             f'but got {dh} and {dw}.')

        feats_ = self.feat_extract(lqs.reshape(-1, c, h, w))
        feats_ = feats_.view(n, t, -1, dh, dw)
        feats = {'spatial': [feats_[:, i] for i in range(t)]}

        flows_forward, flows_backward = self.compute_flow(lqs_downsample)
        for module in self.branches:
            feats[module] = []
            flows = flows_backward if 'backward' in module else flows_forward
            feats = self.propagate(feats, flows, module)
        return self.upsample(lqs, feats)
