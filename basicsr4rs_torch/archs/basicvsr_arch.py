"""BasicVSR and IconVSR, bidirectional recurrent video SR (counterpart of
``basicsr4rs_tpu/archs/basicvsr_arch.py``; reference:
basicsr/archs/basicvsr_arch.py). NCHW; clips (N, T, C, H, W); BasicSR's
module and key layout.

Both directions' flows come from one SpyNet call on the doubled batch, as in
the JAX package. Each branch is a Python loop over the frames (the JAX
package scans a step): a step warps the propagated features by the flow
(one launch of the sampler kernel; the first step of a branch has nothing
to warp), concatenates the frame and runs the trunk. The reconstruction head
runs over all frames at once. IconVSR refills the propagated features from
an EDVR extractor at keyframes: every ``keyframe_stride``-th frame and the
last; the extractor runs on the keyframes' windows in groups of at most
``KEYFRAME_GROUP_PIXELS`` input pixels (the JAX package runs them all in one
call), and the fusion convolution runs at keyframes only (the JAX step runs
it on every frame and keeps it at keyframes), which computes the same.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import ResidualBlockNoBN, flow_warp, make_layer, resize_bilinear
from .edvr_arch import EDVR, PCDAlignment, TSAFusion
from .spynet_arch import SpyNet

# the pixels of the frames one EDVR extractor call takes at most (whole
# keyframe windows, at least one): PCD's nine-tap column tensor is 9 C
# floats a pixel, 1.2 GiB at 64 channels
KEYFRAME_GROUP_PIXELS = 1 << 19


class ConvResidualBlocks(nn.Module):
    """A 3x3 convolution, LeakyReLU(0.1) and ``num_block`` residual blocks."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 64, num_block: int = 15):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(num_in_ch, num_out_ch, 3, 1, 1, bias=True),
            nn.LeakyReLU(negative_slope=0.1, inplace=False),
            make_layer(ResidualBlockNoBN, num_block, num_feat=num_out_ch))

    def forward(self, fea):
        return self.main(fea)


def bidirectional_flows(spynet: nn.Module, lqs: torch.Tensor):
    """(flows_forward, flows_backward), each (N, T-1, 2, H, W), of a clip
    (N, T, C, H, W) from one SpyNet call on both directions: backward is the
    flow from frame i to frame i + 1, forward from i + 1 to i. A clip of one
    frame has no flows."""
    n, t, c, h, w = lqs.shape
    if t == 1:
        empty = lqs.new_zeros(n, 0, 2, h, w)
        return empty, empty
    lqs_1 = lqs[:, :-1].reshape(-1, c, h, w)
    lqs_2 = lqs[:, 1:].reshape(-1, c, h, w)
    flows = spynet(torch.cat([lqs_1, lqs_2], dim=0), torch.cat([lqs_2, lqs_1], dim=0))
    flows_backward, flows_forward = (f.view(n, t - 1, 2, h, w)
                                     for f in torch.chunk(flows, 2, dim=0))
    return flows_forward, flows_backward


def _warp(feat, flow):
    """``flow_warp`` of (N, C, H, W) features by a flow (N, 2, H, W)."""
    return flow_warp(feat, flow.permute(0, 2, 3, 1))


class _ReconstructionHead(nn.Module):
    """Two x2 pixel-shuffle stages, ``conv_hr`` and ``conv_last`` on all
    frames at once, plus the bilinear x4 of the LQ frame."""

    def _head(self, feat, lqs):
        """feat (N*T, C, H, W), lqs (N, T, 3, H, W) -> (N, T, 3, 4H, 4W)."""
        n, t, c, h, w = lqs.shape
        out = self.lrelu(self.pixel_shuffle(self.upconv1(feat)))
        out = self.lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(self.lrelu(self.conv_hr(out)))
        out = out + resize_bilinear(lqs.reshape(n * t, c, h, w), 4 * h, 4 * w)
        return out.view(n, t, 3, 4 * h, 4 * w)

    def _make_head(self, num_feat):
        self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1, bias=True)
        self.upconv2 = nn.Conv2d(num_feat, 64 * 4, 3, 1, 1, bias=True)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        # in place, as BasicSR's: the head holds every frame at 4x at once
        self.lrelu = nn.LeakyReLU(negative_slope=0.1, inplace=True)


@ARCH_REGISTRY.register()
class BasicVSR(_ReconstructionHead):
    """Clips (N, T, 3, H, W) in, (N, T, 3, 4H, 4W) out; H and W at least 64
    for SpyNet's pyramid."""

    JAX_KEY_RULES = ()   # the general rules of utils.jax_convert suffice

    def __init__(self, num_feat: int = 64, num_block: int = 15,
                 spynet_path: Optional[str] = None):
        super().__init__()
        self.num_feat = num_feat
        self.spynet = SpyNet(spynet_path)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat, num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat, num_block)
        self.fusion = nn.Conv2d(num_feat * 2, num_feat, 1, 1, 0, bias=True)
        self._make_head(num_feat)

    def forward(self, x):
        b, n, _, h, w = x.shape
        flows_forward, flows_backward = bidirectional_flows(self.spynet, x)

        out_l: List[Optional[torch.Tensor]] = [None] * n
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = _warp(feat_prop, flows_backward[:, i])
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop], dim=1))
            out_l[i] = feat_prop

        feats_f = []
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n):
            if i > 0:
                feat_prop = _warp(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_trunk(torch.cat([x[:, i], feat_prop], dim=1))
            feats_f.append(feat_prop)

        feat = torch.cat([torch.stack(out_l, dim=1), torch.stack(feats_f, dim=1)], dim=2)
        feat = self.lrelu(self.fusion(feat.view(b * n, 2 * self.num_feat, h, w)))
        return self._head(feat, x)


class EDVRFeatureExtractor(nn.Module):
    """EDVR without its reconstruction: pyramid features, PCD alignment of
    every frame to the centre one (the frames folded into the batch, four
    sampler launches a call) and TSA fusion. (B, T, 3, H, W) -> (B, C, H, W),
    H and W multiples of 4."""

    def __init__(self, num_input_frame: int, num_feat: int, load_path: Optional[str] = None):
        super().__init__()
        self.center_frame_idx = num_input_frame // 2
        self.conv_first = nn.Conv2d(3, num_feat, 3, 1, 1)
        self.feature_extraction = make_layer(ResidualBlockNoBN, 5, num_feat=num_feat)
        self.conv_l2_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat=num_feat, deformable_groups=8)
        self.fusion = TSAFusion(num_feat=num_feat, num_frame=num_input_frame,
                                center_frame_idx=self.center_frame_idx)
        self.lrelu = nn.LeakyReLU(negative_slope=0.1)
        if load_path:
            state = torch.load(load_path, map_location='cpu', weights_only=True)
            self.load_state_dict(state.get('params', state))

    def forward(self, x):
        b, t, c, h, w = x.shape
        feat_l1 = self.feature_extraction(self.lrelu(self.conv_first(x.reshape(-1, c, h, w))))
        feat_l2 = self.lrelu(self.conv_l2_2(self.lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = self.lrelu(self.conv_l3_2(self.lrelu(self.conv_l3_1(feat_l2))))
        nbr_feat_l = [feat_l1, feat_l2, feat_l3]
        ref_feat_l = []
        for feats in nbr_feat_l:
            ref = feats.view(b, t, *feats.shape[1:])[:, self.center_frame_idx:
                                                     self.center_frame_idx + 1]
            ref_feat_l.append(ref.expand(-1, t, -1, -1, -1).reshape(feats.shape))
        aligned_feat = self.pcd_align(nbr_feat_l, ref_feat_l).view(b, t, -1, h, w)
        return self.fusion(aligned_feat)


def keyframes(n: int, keyframe_stride: int) -> List[int]:
    """IconVSR's keyframes of a clip of ``n`` frames: every
    ``keyframe_stride``-th frame and the last."""
    idx = list(range(0, n, keyframe_stride))
    if idx[-1] != n - 1:
        idx.append(n - 1)
    return idx


def keyframe_groups(b: int, n: int, h: int, w: int, keyframe_stride: int,
                    temporal_padding: int) -> List[List[int]]:
    """The keyframes of a clip (b, n, 3, h, w) (h, w padded to multiples of
    4) in the groups that each take one EDVR extractor call: as many whole
    windows of 2 * ``temporal_padding`` + 1 frames as ``KEYFRAME_GROUP_PIXELS``
    holds, at least one."""
    size = max(1, KEYFRAME_GROUP_PIXELS // (b * (2 * temporal_padding + 1) * h * w))
    idx = keyframes(n, keyframe_stride)
    return [idx[i:i + size] for i in range(0, len(idx), size)]


# the frames that pad a clip in time for the keyframe windows, by
# ``temporal_padding``: mirrored around the clip's second and second-last
# frames, as BasicSR does
_TEMPORAL_PADDING = {2: ([4, 3], [-4, -5]), 3: ([6, 5, 4], [-5, -6, -7])}


@ARCH_REGISTRY.register()
class IconVSR(_ReconstructionHead):
    """Clips (N, T, 3, H, W) in, (N, T, 3, 4H, 4W) out; T >= 2 *
    ``temporal_padding`` + 1 (BasicSR's indexing; a shorter clip raises),
    H and W at least 64. The clip is reflect-padded to multiples of 4 for
    PCD and the output cropped back."""

    # Flax scope names -> BasicSR keys: the scanned steps hold each branch's
    # trunk and fusion (prop_<branch>.trunk, prop_<branch>.fusion); the
    # extractor's names are EDVR's
    JAX_KEY_RULES = ((r'^prop_(backward|forward)\.(trunk|fusion)\.', r'\1_\2.'),
                     ) + EDVR.JAX_KEY_RULES

    def __init__(self, num_feat: int = 64, num_block: int = 15, keyframe_stride: int = 5,
                 temporal_padding: int = 2, spynet_path: Optional[str] = None,
                 edvr_path: Optional[str] = None):
        super().__init__()
        if temporal_padding not in _TEMPORAL_PADDING:
            raise ValueError(f'Unsupported temporal_padding {temporal_padding}')
        self.num_feat = num_feat
        self.temporal_padding = temporal_padding
        self.keyframe_stride = keyframe_stride
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat, edvr_path)
        self.spynet = SpyNet(spynet_path)
        self.backward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1, bias=True)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat, num_block)
        self.forward_fusion = nn.Conv2d(2 * num_feat, num_feat, 3, 1, 1, bias=True)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat, num_block)
        self._make_head(num_feat)

    def keyframe_features(self, x):
        """{keyframe: (b, C, h, w)} from the EDVR extractor on each
        keyframe's window of the clip padded in time."""
        b, n, c, h, w = x.shape
        num_frames = 2 * self.temporal_padding + 1
        if n < num_frames:
            raise ValueError(f'IconVSR with temporal_padding {self.temporal_padding} needs '
                             f'clips of at least {num_frames} frames, got {n}')
        head, tail = _TEMPORAL_PADDING[self.temporal_padding]
        x_pad = torch.cat([x[:, head], x, x[:, tail]], dim=1)
        feats = {}
        for group in keyframe_groups(b, n, h, w, self.keyframe_stride, self.temporal_padding):
            windows = torch.cat([x_pad[:, i:i + num_frames] for i in group], dim=0)
            for i, feat in zip(group, self.edvr(windows).split(b, dim=0)):
                feats[i] = feat
        return feats

    def forward(self, x):
        b, n, c, h_input, w_input = x.shape
        pad_h, pad_w = (4 - h_input % 4) % 4, (4 - w_input % 4) % 4
        if pad_h or pad_w:
            x = F.pad(x.reshape(-1, c, h_input, w_input), [0, pad_w, 0, pad_h],
                      mode='reflect').view(b, n, c, h_input + pad_h, w_input + pad_w)
        h, w = x.shape[3:]
        feats_keyframe = self.keyframe_features(x)
        flows_forward, flows_backward = bidirectional_flows(self.spynet, x)

        out_l: List[Optional[torch.Tensor]] = [None] * n
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                feat_prop = _warp(feat_prop, flows_backward[:, i])
            if i in feats_keyframe:
                feat_prop = self.backward_fusion(torch.cat([feat_prop, feats_keyframe[i]], dim=1))
            feat_prop = self.backward_trunk(torch.cat([x[:, i], feat_prop], dim=1))
            out_l[i] = feat_prop

        feats_f = []
        feat_prop = x.new_zeros(b, self.num_feat, h, w)
        for i in range(n):
            if i > 0:
                feat_prop = _warp(feat_prop, flows_forward[:, i - 1])
            if i in feats_keyframe:
                feat_prop = self.forward_fusion(torch.cat([feat_prop, feats_keyframe[i]], dim=1))
            feat_prop = self.forward_trunk(torch.cat([x[:, i], out_l[i], feat_prop], dim=1))
            feats_f.append(feat_prop)

        out = self._head(torch.stack(feats_f, dim=1).view(b * n, self.num_feat, h, w), x)
        return out[..., :4 * h_input, :4 * w_input]
