"""EDVR: video restoration with pyramid, cascading and deformable (PCD)
alignment and temporal-spatial attention (TSA) fusion (counterpart of
``basicsr4rs_tpu/archs/edvr_arch.py``; reference: basicsr/archs/edvr_arch.py).
NCHW; frames (B, T, C, H, W); BasicSR's module and key layout."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import DCNv2Pack
from ..utils.registry import ARCH_REGISTRY
from .arch_util import ResidualBlockNoBN, make_layer


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)


class PCDAlignment(nn.Module):
    """Three pyramid levels of deformable alignment, coarse to fine, and a
    cascading one on top: four deformable convolutions a call."""

    def __init__(self, num_feat: int = 64, deformable_groups: int = 8):
        super().__init__()
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            level = f'l{i}'
            self.offset_conv1[level] = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
            if i == 3:
                self.offset_conv2[level] = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            else:
                self.offset_conv2[level] = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
                self.offset_conv3[level] = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.dcn_pack[level] = DCNv2Pack(num_feat, num_feat, 3, padding=1,
                                             deformable_groups=deformable_groups)
            if i < 3:
                self.feat_conv[level] = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
        self.cas_offset_conv1 = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
        self.cas_offset_conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.cas_dcnpack = DCNv2Pack(num_feat, num_feat, 3, padding=1,
                                     deformable_groups=deformable_groups)
        self.lrelu = nn.LeakyReLU(negative_slope=0.1)

    def forward(self, nbr_feat_l: List[torch.Tensor], ref_feat_l: List[torch.Tensor]):
        """Three levels (L1, L2, L3) of neighbour and reference features,
        each (B, C, H, W) at its level's size; returns the aligned L1 map."""
        upsampled_offset, upsampled_feat, feat = None, None, None
        for i in range(3, 0, -1):
            level = f'l{i}'
            offset = torch.cat([nbr_feat_l[i - 1], ref_feat_l[i - 1]], dim=1)
            offset = self.lrelu(self.offset_conv1[level](offset))
            if i == 3:
                offset = self.lrelu(self.offset_conv2[level](offset))
            else:
                offset = self.lrelu(self.offset_conv2[level](
                    torch.cat([offset, upsampled_offset], dim=1)))
                offset = self.lrelu(self.offset_conv3[level](offset))
            feat = self.dcn_pack[level](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[level](torch.cat([feat, upsampled_feat], dim=1))
            if i > 1:
                feat = self.lrelu(feat)
                upsampled_offset = _up2(offset) * 2
                upsampled_feat = _up2(feat)
        offset = torch.cat([feat, ref_feat_l[0]], dim=1)
        offset = self.lrelu(self.cas_offset_conv2(self.lrelu(self.cas_offset_conv1(offset))))
        return self.lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    """Temporal attention (each frame's correlation with the centre frame)
    and a three-level spatial attention over the fused features."""

    def __init__(self, num_feat: int = 64, num_frame: int = 5, center_frame_idx: int = 2):
        super().__init__()
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.temporal_attn2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.feat_fusion = nn.Conv2d(num_frame * num_feat, num_feat, 1, 1)
        # avg_pool counts the zero padding, as the JAX package's does
        self.max_pool = nn.MaxPool2d(3, stride=2, padding=1)
        self.avg_pool = nn.AvgPool2d(3, stride=2, padding=1)
        self.spatial_attn1 = nn.Conv2d(num_frame * num_feat, num_feat, 1)
        self.spatial_attn2 = nn.Conv2d(num_feat * 2, num_feat, 1)
        self.spatial_attn3 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.spatial_attn4 = nn.Conv2d(num_feat, num_feat, 1)
        self.spatial_attn5 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.spatial_attn_l1 = nn.Conv2d(num_feat, num_feat, 1)
        self.spatial_attn_l2 = nn.Conv2d(num_feat * 2, num_feat, 3, 1, 1)
        self.spatial_attn_l3 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.spatial_attn_add1 = nn.Conv2d(num_feat, num_feat, 1)
        self.spatial_attn_add2 = nn.Conv2d(num_feat, num_feat, 1)
        self.lrelu = nn.LeakyReLU(negative_slope=0.1)

    def forward(self, aligned_feat):
        """aligned_feat (B, T, C, H, W) -> (B, C, H, W)."""
        b, t, c, h, w = aligned_feat.shape
        embedding_ref = self.temporal_attn1(aligned_feat[:, self.center_frame_idx])
        embedding = self.temporal_attn2(aligned_feat.reshape(-1, c, h, w)).view(b, t, -1, h, w)
        corr = torch.sum(embedding * embedding_ref.unsqueeze(1), dim=2)      # (b, t, h, w)
        corr_prob = torch.sigmoid(corr).unsqueeze(2)
        aligned_feat = (aligned_feat * corr_prob).reshape(b, t * c, h, w)

        feat = self.lrelu(self.feat_fusion(aligned_feat))

        attn = self.lrelu(self.spatial_attn1(aligned_feat))
        attn = self.lrelu(self.spatial_attn2(
            torch.cat([self.max_pool(attn), self.avg_pool(attn)], dim=1)))
        attn_level = self.lrelu(self.spatial_attn_l1(attn))
        attn_level = self.lrelu(self.spatial_attn_l2(
            torch.cat([self.max_pool(attn_level), self.avg_pool(attn_level)], dim=1)))
        attn_level = _up2(self.lrelu(self.spatial_attn_l3(attn_level)))

        attn = self.lrelu(self.spatial_attn3(attn)) + attn_level
        attn = _up2(self.lrelu(self.spatial_attn4(attn)))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(self.lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class PredeblurModule(nn.Module):
    """A three-level residual pyramid in front of the alignment, for blurry
    input."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, hr_in: bool = False):
        super().__init__()
        self.hr_in = hr_in
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        if hr_in:
            self.stride_conv_hr1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
            self.stride_conv_hr2 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.stride_conv_l2 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.stride_conv_l3 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.resblock_l3 = ResidualBlockNoBN(num_feat=num_feat)
        self.resblock_l2_1 = ResidualBlockNoBN(num_feat=num_feat)
        self.resblock_l2_2 = ResidualBlockNoBN(num_feat=num_feat)
        self.resblock_l1 = nn.ModuleList([ResidualBlockNoBN(num_feat=num_feat) for _ in range(5)])
        self.lrelu = nn.LeakyReLU(negative_slope=0.1)

    def forward(self, x):
        feat_l1 = self.lrelu(self.conv_first(x))
        if self.hr_in:
            feat_l1 = self.lrelu(self.stride_conv_hr1(feat_l1))
            feat_l1 = self.lrelu(self.stride_conv_hr2(feat_l1))
        feat_l2 = self.lrelu(self.stride_conv_l2(feat_l1))
        feat_l3 = self.lrelu(self.stride_conv_l3(feat_l2))
        feat_l3 = _up2(self.resblock_l3(feat_l3))
        feat_l2 = self.resblock_l2_1(feat_l2) + feat_l3
        feat_l2 = _up2(self.resblock_l2_2(feat_l2))
        for i in range(2):
            feat_l1 = self.resblock_l1[i](feat_l1)
        feat_l1 = feat_l1 + feat_l2
        for i in range(2, 5):
            feat_l1 = self.resblock_l1[i](feat_l1)
        return feat_l1


@ARCH_REGISTRY.register()
class EDVR(nn.Module):
    """Input (B, T, C, H, W); output the centre frame at x4 (or at the input's
    size with ``hr_in``).

    The neighbours are aligned in one PCD call with the frames folded into
    the batch, as in the JAX package: four deformable convolutions a
    forward, whatever ``num_frame``."""

    # Flax scope names -> BasicSR keys: the ModuleDict levels, and the names
    # that end in a digit without being list entries
    JAX_KEY_RULES = ((r'(offset_conv\d|dcn_pack|feat_conv)_(l\d)\.', r'\1.\2.'),
                     (r'(conv_l\d|resblock_l2)\.(\d)\.', r'\1_\2.'))

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_frame: int = 5, deformable_groups: int = 8, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10, center_frame_idx: Optional[int] = None,
                 hr_in: bool = False, with_predeblur: bool = False, with_tsa: bool = True):
        super().__init__()
        self.center_frame_idx = num_frame // 2 if center_frame_idx is None else center_frame_idx
        self.hr_in, self.with_predeblur, self.with_tsa = hr_in, with_predeblur, with_tsa

        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch=num_in_ch, num_feat=num_feat, hr_in=hr_in)
            self.conv_1x1 = nn.Conv2d(num_feat, num_feat, 1, 1)
        else:
            self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.feature_extraction = make_layer(ResidualBlockNoBN, num_extract_block,
                                             num_feat=num_feat)
        self.conv_l2_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat=num_feat, deformable_groups=deformable_groups)
        if with_tsa:
            self.fusion = TSAFusion(num_feat=num_feat, num_frame=num_frame,
                                    center_frame_idx=self.center_frame_idx)
        else:
            self.fusion = nn.Conv2d(num_frame * num_feat, num_feat, 1, 1)
        self.reconstruction = make_layer(ResidualBlockNoBN, num_reconstruct_block,
                                         num_feat=num_feat)
        self.upconv1 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(num_feat, 64 * 4, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, num_out_ch, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(negative_slope=0.1)

    def forward(self, x):
        b, t, c, h, w = x.shape
        multiple = 16 if self.hr_in else 4
        if h % multiple or w % multiple:
            raise ValueError(f'The height and width must be multiple of {multiple}.')
        x_center = x[:, self.center_frame_idx].contiguous()

        flat = x.reshape(-1, c, h, w)
        if self.with_predeblur:
            feat_l1 = self.conv_1x1(self.predeblur(flat))
            if self.hr_in:
                h, w = h // 4, w // 4
        else:
            feat_l1 = self.lrelu(self.conv_first(flat))
        feat_l1 = self.feature_extraction(feat_l1)
        feat_l2 = self.lrelu(self.conv_l2_2(self.lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = self.lrelu(self.conv_l3_2(self.lrelu(self.conv_l3_1(feat_l2))))

        # frames folded into the batch: one PCD body at batch b * t
        nbr_feat_l = [feat_l1, feat_l2, feat_l3]
        ref_feat_l = []
        for feats in nbr_feat_l:
            per_frame = feats.view(b, t, *feats.shape[1:])
            ref = per_frame[:, self.center_frame_idx:self.center_frame_idx + 1]
            ref_feat_l.append(ref.expand(-1, t, -1, -1, -1).reshape(feats.shape))
        aligned_feat = self.pcd_align(nbr_feat_l, ref_feat_l).view(b, t, -1, h, w)

        if self.with_tsa:
            feat = self.fusion(aligned_feat)
        else:
            feat = self.fusion(aligned_feat.reshape(b, -1, h, w))

        out = self.reconstruction(feat)
        out = self.lrelu(self.pixel_shuffle(self.upconv1(out)))
        out = self.lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(self.lrelu(self.conv_hr(out)))
        if self.hr_in:
            base = x_center
        else:
            base = F.interpolate(x_center, scale_factor=4, mode='bilinear', align_corners=False)
        return out + base
