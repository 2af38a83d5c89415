"""Official-checkpoint key maps (counterpart of
``scripts/model_conversion/zoo_remaps.py``; reference:
scripts/model_conversion/convert_{models,dfdnet,ridnet,stylegan}.py).

Each function maps one key of an official checkpoint (the original authors'
names) to BasicSR's key, or to ``None`` to drop it (EDSR's and RCAN's mean
shifts, which BasicSR keeps as constants). ``remap_state_dict`` applies a key
function over a whole checkpoint; the result is a state dict the port's
networks load as is. The same functions as the JAX package's, without its
Orbax step, and on torch tensors; ``remap_dfdnet`` also maps the names the
JAX package's version leaves as they are (its docstring lists them).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch


def remap_state_dict(state: Dict, key_fn: Callable[[str], Optional[str]]) -> 'OrderedDict':
    out = OrderedDict()
    for k, v in state.items():
        nk = key_fn(k)
        if nk is not None:
            out[nk] = v
    return out


# --------------------------------------------------------------- EDSR
def remap_edsr(key: str, num_block: int = 32) -> Optional[str]:
    """EDSR-PyTorch (thstkdgus35) -> BasicSR ``EDSR``."""
    if key.startswith(('sub_mean', 'add_mean')):
        return None   # BasicSR's mean shift is a constant
    if key.startswith('head.0.'):
        return key.replace('head.0.', 'conv_first.')
    m = re.match(r'body\.(\d+)\.body\.([02])\.(.+)', key)
    if m:
        i, conv, rest = m.groups()
        return f'body.{i}.conv{1 if conv == "0" else 2}.{rest}'
    if key.startswith(f'body.{num_block}.'):
        return key.replace(f'body.{num_block}.', 'conv_after_body.')
    if key.startswith('tail.0.0.'):
        return key.replace('tail.0.0.', 'upsample.0.')
    if key.startswith('tail.0.2.'):
        return key.replace('tail.0.2.', 'upsample.2.')
    if key.startswith('tail.1.'):
        return key.replace('tail.1.', 'conv_last.')
    return key


# --------------------------------------------------------------- RCAN
def remap_rcan(key: str, num_group: int = 10, num_block: int = 20) -> Optional[str]:
    """Official RCAN -> BasicSR ``RCAN``."""
    if key.startswith(('sub_mean', 'add_mean')):
        return None
    if key.startswith('head.0.'):
        return key.replace('head.0.', 'conv_first.')
    m = re.match(r'body\.(\d+)\.body\.(\d+)\.body\.(\d+)\.conv_du\.(\d+)\.(.+)', key)
    if m:
        g, b, c, du, rest = m.groups()
        # conv_du.{0,2} -> attention.{1,3}
        return f'body.{g}.residual_group.{b}.rcab.{c}.attention.{int(du) + 1}.{rest}'
    m = re.match(r'body\.(\d+)\.body\.(\d+)\.body\.(\d+)\.(.+)', key)
    if m:
        g, b, c, rest = m.groups()
        return f'body.{g}.residual_group.{b}.rcab.{c}.{rest}'
    m = re.match(rf'body\.(\d+)\.body\.{num_block}\.(.+)', key)
    if m:
        g, rest = m.groups()
        return f'body.{g}.conv.{rest}'
    if key.startswith(f'body.{num_group}.'):
        return key.replace(f'body.{num_group}.', 'conv_after_body.')
    if key.startswith('tail.0.0.'):
        return key.replace('tail.0.0.', 'upsample.0.')
    if key.startswith('tail.0.2.'):
        return key.replace('tail.0.2.', 'upsample.2.')
    if key.startswith('tail.1.'):
        return key.replace('tail.1.', 'conv_last.')
    return key


# --------------------------------------------------------------- ESRGAN
def remap_esrgan_rrdb(key: str) -> Optional[str]:
    """Official ESRGAN RRDB -> BasicSR ``RRDBNet``."""
    key = key.replace('RRDB_trunk', 'body').replace('RDB', 'rdb')
    key = key.replace('trunk_conv', 'conv_body')
    key = key.replace('upconv', 'conv_up')
    key = key.replace('HRconv', 'conv_hr')
    return key


# --------------------------------------------------------------- EDVR
_EDVR_RULES = (
    (r'^pre_deblur\.conv_first_1\.', 'predeblur.conv_first.'),
    (r'^pre_deblur\.conv_first_2\.', 'predeblur.stride_conv_hr1.'),
    (r'^pre_deblur\.conv_first_3\.', 'predeblur.stride_conv_hr2.'),
    (r'^pre_deblur\.deblur_L2_conv\.', 'predeblur.stride_conv_l2.'),
    (r'^pre_deblur\.deblur_L3_conv\.', 'predeblur.stride_conv_l3.'),
    (r'^pre_deblur\.RB_L3_1\.', 'predeblur.resblock_l3.'),
    (r'^pre_deblur\.RB_L2_(\d)\.', r'predeblur.resblock_l2_\1.'),
    (r'^pre_deblur\.RB_L1_(\d+)\.', lambda m: f'predeblur.resblock_l1.{int(m.group(1)) - 1}.'),
    (r'^fea_L(\d)_conv(\d)\.', r'conv_l\1_\2.'),
    (r'^pcd_align\.L(\d)_dcnpack\.conv_offset_mask\.(.+)$',
     r'pcd_align.dcn_pack.l\1.conv_offset.\2'),
    (r'^pcd_align\.L(\d)_dcnpack\.(.+)$', r'pcd_align.dcn_pack.l\1.\2'),
    (r'^pcd_align\.L(\d)_offset_conv(\d)\.(.+)$', r'pcd_align.offset_conv\2.l\1.\3'),
    (r'^pcd_align\.L(\d)_fea_conv\.(.+)$', r'pcd_align.feat_conv.l\1.\2'),
    (r'^pcd_align\.cas_dcnpack\.conv_offset_mask\.', 'pcd_align.cas_dcnpack.conv_offset.'),
    (r'^tsa_fusion\.tAtt_2\.', 'fusion.temporal_attn1.'),
    (r'^tsa_fusion\.tAtt_1\.', 'fusion.temporal_attn2.'),
    (r'^tsa_fusion\.fea_fusion\.', 'fusion.feat_fusion.'),
    (r'^tsa_fusion\.sAtt_add_(\d)\.', r'fusion.spatial_attn_add\1.'),
    (r'^tsa_fusion\.sAtt_L(\d)\.', r'fusion.spatial_attn_l\1.'),
    (r'^tsa_fusion\.sAtt_(\d)\.', r'fusion.spatial_attn\1.'),
    (r'^recon_trunk\.', 'reconstruction.'),
    (r'^HRconv\.', 'conv_hr.'),
)


def remap_edvr(key: str) -> Optional[str]:
    """Official EDVR -> BasicSR ``EDVR``: the first rule that matches; the
    names it does not rename (``conv_first``, ``feature_extraction``,
    ``upconv*``, ``conv_last``, ``conv_1x1``, ``pcd_align.cas_offset_conv*``)
    are BasicSR's already."""
    for pat, repl in _EDVR_RULES:
        new, cnt = re.subn(pat, repl, key)
        if cnt:
            return new
    return key


# ----------------------------------------------------------------- DUF
def remap_duf_16l(key: str) -> Optional[str]:
    """Official DUF (16 layers) -> BasicSR ``DUF`` with
    ``adapt_official_weights``."""
    key = re.sub(r'^conv3d_(\d)\.', r'conv3d\1.', key)
    key = re.sub(r'^bn3d_2\.', 'bn3d2.', key)
    m = re.match(r'^dense_block_(1|2)\.(bn3d|conv3d)_(\d)\.(.+)$', key)
    if m:
        blk, kind, idx, rest = m.groups()
        pair, sub = divmod(int(idx) - 1, 2)
        # each Sequential is (bn, relu, conv, bn, relu (+pad), conv): the
        # official bn / conv pairs land at slots 0 / 2, then 3 / 5
        slot = {(0, 'bn3d'): '0', (0, 'conv3d'): '2',
                (1, 'bn3d'): '3', (1, 'conv3d'): '5'}[(sub, kind)]
        if blk == '1':
            return f'dense_block1.dense_blocks.{pair}.{slot}.{rest}'
        return f'dense_block2.temporal_reduce{pair + 1}.{slot}.{rest}'
    return key


def reorder_duf_r2(weight, bias, scale: int):
    """DUF's residual head: the official filters interleave R, G, B
    (r0 g0 b0 r1 g1 b1 ...), BasicSR's group them by channel (r0 r1 ...,
    g0 ..., b0 ...). ``weight`` is (3 * scale**2, ...), ``bias``
    (3 * scale**2,); tensors or arrays in, tensors out."""
    w, b = torch.as_tensor(weight), torch.as_tensor(bias)
    w2, b2 = w.clone(), b.clone()
    s2 = scale * scale
    for i in range(3):
        w2[i * s2:(i + 1) * s2] = w[i::3]
        b2[i * s2:(i + 1) * s2] = b[i::3]
    return w2, b2


# ------------------------------------------------------------- RIDNet
def remap_ridnet_positional(official_state: Dict, target_names: Sequence[str]) -> 'OrderedDict':
    """The official RIDNet checkpoint holds its parameters in definition
    order under other names: the map is by position."""
    values = list(official_state.values())
    names = list(target_names)
    if len(values) != len(names):
        raise ValueError(f'parameter count mismatch: official {len(values)} '
                         f'vs target {len(names)}')
    return OrderedDict(zip(names, values))


# ---------------------------------------------------------- StyleGAN2
def remap_stylegan2_g(key: str, shape) -> Optional[str]:
    """stylegan2-pytorch (rosinality) generator -> BasicSR
    ``StyleGAN2Generator``; ``shape`` tells the noise strengths (shape
    ``(1,)``) from the other weights."""
    if key.startswith('style.'):
        return key.replace('style.', 'style_mlp.', 1)
    if key == 'input.input':
        return 'constant_input.weight'
    if key.startswith('conv1.conv.'):
        return key.replace('conv1.conv.', 'style_conv1.modulated_conv.', 1)
    if key.startswith('conv1.noise.'):
        return key.replace('conv1.noise.', 'style_conv1.', 1)
    if key.startswith('conv1.'):
        return key.replace('conv1.', 'style_conv1.', 1)
    if key.startswith('convs.'):
        nk = key.replace('convs.', 'style_convs.', 1).replace('.conv.', '.modulated_conv.')
        return nk.replace('.noise.weight', '.weight') if tuple(shape) == (1,) else nk
    if key.startswith('to_rgb1.conv.'):
        return key.replace('to_rgb1.conv.', 'to_rgb1.modulated_conv.', 1)
    if key.startswith('to_rgbs.'):
        return key.replace('.conv.', '.modulated_conv.')
    if key.startswith('noises.noise_'):
        return key.replace('noises.noise_', 'noises.noise', 1)
    return key


def remap_stylegan2_d(key: str) -> Optional[str]:
    """rosinality discriminator -> BasicSR ``StyleGAN2Discriminator``."""
    if key.startswith('convs.'):
        return key.replace('convs.', 'conv_body.', 1)
    return key


# ------------------------------------------------------------- DFDNet
_DFDNET_PARTS = {'le': 'left_eye', 're': 'right_eye', 'mo': 'mouth', 'no': 'nose'}


def remap_dfdnet(key: str, vgg_names: Optional[Sequence[str]] = None) -> Optional[str]:
    """Official DFDNet -> BasicSR ``DFDNet``.

    As the JAX package's version: ``le.`` / ``re.`` / ``mo.`` / ``no.`` ->
    ``attn_blocks.<part>.``, ``MSDilate.conv<i>`` -> ``conv_blocks.<i-1>``,
    ``MSDilate.convi`` -> ``conv_fusion``, ``VggExtract`` -> ``vgg_extractor``
    (``RGB_mean`` / ``RGB_std`` -> ``mean`` / ``std``). Past it, the names
    the official network really has and that version leaves as they are:
    the attention blocks ``le_256.`` -> ``attn_blocks.left_eye_256.``, the
    decoder ``up<i>.`` -> ``upsample<i>.`` (``ScaleModel1`` / ``ShiftModel1``
    -> ``scale_block`` / ``shift_block``, ``Model`` -> ``body``) and, given
    ``vgg_names`` (torchvision's ``features`` index -> BasicSR's layer name,
    ``archs.vgg_arch.vgg_layer_names('vgg19')``),
    ``VggExtract.model.features.<i>`` -> ``vgg_extractor.vgg_net.<name>``;
    the official VGG's other copies and its classifier are then dropped."""
    m = re.match(r'^(le|re|mo|no)([._])(.+)$', key)
    if m:
        part, sep, rest = m.groups()
        return f'attn_blocks.{_DFDNET_PARTS[part]}{sep}{rest}'
    m = re.match(r'^MSDilate\.conv(\d)\.(.+)$', key)
    if m:
        return f'multi_scale_dilation.conv_blocks.{int(m.group(1)) - 1}.{m.group(2)}'
    if key.startswith('MSDilate.convi.'):
        return key.replace('MSDilate.convi.', 'multi_scale_dilation.conv_fusion.', 1)
    if key.startswith('VggExtract.'):
        if vgg_names is not None and not key.startswith('VggExtract.RGB_'):
            m = re.match(r'^VggExtract\.model\.features\.(\d+)\.(.+)$', key)
            if m is None:
                return None
            return f'vgg_extractor.vgg_net.{vgg_names[int(m.group(1))]}.{m.group(2)}'
        nk = key.replace('VggExtract.', 'vgg_extractor.', 1).replace('model.', 'vgg_net.')
        return nk.replace('RGB_mean', 'mean').replace('RGB_std', 'std')
    m = re.match(r'^up(\d)\.(.+)$', key)
    if m:
        rest = m.group(2).replace('ScaleModel1', 'scale_block')
        rest = rest.replace('ShiftModel1', 'shift_block')
        rest = re.sub(r'^(\d+)\.Model\.', r'\1.body.', rest)
        return f'upsample{m.group(1)}.{rest}'
    return key
