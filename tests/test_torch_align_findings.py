"""The published RS configs in the port: every ``type`` and ``model_type`` of
the ``*L2S*``, ``*S2N*`` and ``*Square192*`` option files resolves in the
port's registries; the three published alignment configs that stop in the
JAX package stop in the port at the same point (each shown in both
packages, at test widths); the synthetic alignment and SRCNN configs parse
and refuse to run without a card unless ``num_gpu: 0``."""

import copy
import glob
import os
import sys

import pytest
import torch

import basicsr4rs_torch.archs  # noqa: F401
import basicsr4rs_torch.data  # noqa: F401
import basicsr4rs_torch.losses  # noqa: F401
import basicsr4rs_torch.metrics  # noqa: F401
import basicsr4rs_torch.models  # noqa: F401
import basicsr4rs_torch.test as port_test
import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_torch.utils.registry import (ARCH_REGISTRY, DATASET_REGISTRY, LOSS_REGISTRY,
                                             METRIC_REGISTRY, MODEL_REGISTRY)
from basicsr4rs_tpu.models import build_model as jax_build_model

from test_torch_align import AE, LR
from test_torch_align_models import l2s_batch

ROOT = os.path.join(os.path.dirname(__file__), '..')
RS_OPTIONS = sorted(p for p in glob.glob(os.path.join(ROOT, 'options', '**', '*.yml'),
                                         recursive=True)
                    if any(k in os.path.basename(p) for k in ('L2S', 'S2N', 'Square192')))
SYNTHETIC = {
    'registration': ('train', 'AlignAutoencoder', 'train_Registration_L2S_Square192_synthetic'),
    'joint': ('train', 'AlignResDiff', 'train_AlignResDiff_3loss_L2S_Square192_synthetic'),
    'joint-test': ('test', 'AlignResDiff', 'test_AlignResDiff_3loss_L2S_Square192_synthetic'),
    'srcnn': ('train', 'SRCNN', 'train_SRCNN_L2S288_synthetic'),
}
# a UNet of the published image_size 64 at test width: one level of 8
# channels, its one Swin layer in the middle at window 8
TINY_UNET = dict(model_channels=8, channel_mult=[1], num_res_blocks=[1], attention_resolutions=[],
                 swin_embed_dim=8, num_head_channels=4)


def plain(tree):
    """Nested mappings as plain dicts, to compare without their order."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return tree


def config(*parts):
    return os.path.join(ROOT, 'options', *parts)


def named_types(opt):
    """(registry, name) of every component an option file names."""
    names = [(MODEL_REGISTRY, opt['model_type'])]
    names += [(ARCH_REGISTRY, v['type']) for v in opt.values()
              if isinstance(v, dict) and 'type' in v]
    names += [(DATASET_REGISTRY, d['type']) for d in (opt.get('datasets') or {}).values()]
    names += [(LOSS_REGISTRY, v['type']) for k, v in (opt.get('train') or {}).items()
              if k.endswith('_opt') and k != 'optim_g' and isinstance(v, dict)]
    names += [(METRIC_REGISTRY, m['type'])
              for m in ((opt.get('val') or {}).get('metrics') or {}).values()]
    return names


def test_the_rs_option_files_are_the_twenty_and_their_synthetic_copies():
    names = {os.path.basename(p) for p in RS_OPTIONS}
    published = {n for n in names if 'synthetic' not in n}
    assert len(published) == 16 and len(names) == 24, sorted(names)


@pytest.mark.parametrize('path', RS_OPTIONS, ids=os.path.basename)
def test_every_rs_option_file_names_only_ported_types(path):
    missing = [name for registry, name in named_types(yaml_load(path)) if name not in registry]
    assert not missing, missing


def shrunk(path, **network):
    """A published option file on the CPU at test width: the alignment
    networks at 8 features and one block, the UNet as ``TINY_UNET`` and
    ``network``."""
    opt = yaml_load(path)
    opt.update(num_gpu=0, is_train=True, dist=False, rank=0, world_size=1)
    opt['path'] = {'pretrain_network_g': None, 'pretrain_network_ae': None,
                   'strict_load_g': True}
    opt['train']['use_amp'] = False
    net = opt['network_g']
    if net['type'] == 'ResNetAE_SwinUNet':
        net['align_autoencoder_args'] = dict(AE)
        net['lr_encoder_args'] = dict(LR)
        net = net['unet_args']
    net.update(TINY_UNET, **network)
    if 'autoencoder' in opt:
        opt['autoencoder'].update(num_feat=8, num_block=1)
    return opt


def both(opt):
    """The two packages' models of ``opt``; the JAX UNet without ``dims``
    and ``use_fp16``, which the Flax module does not take."""
    jax_opt = copy.deepcopy(opt)
    net = jax_opt['network_g']
    for key in ('dims', 'use_fp16'):
        net.get('unet_args', net).pop(key)
    return port_build_model(copy.deepcopy(opt)), jax_build_model(jax_opt)


def test_resshift_with_an_align_first_stage_fails_in_both_packages():
    """Finding 3: ``train_Align_RSResDiff_L2S_Square192.yml`` runs the base
    engine (``RSResDiffModel``) over an ``AlignAutoencoder`` with no
    ``scale_factor``: the first step stops in ``encode_first_stage``."""
    opt = shrunk(config('train', 'ResDiff', 'train_Align_RSResDiff_L2S_Square192.yml'))
    assert 'scale_factor' not in opt['diffusion'] and not opt['diffusion']['latent_flag']
    port, jax_model = both(opt)
    jax_batch, port_batch = l2s_batch(5, b=1, lq=64)
    port.feed_data(port_batch)
    jax_model.feed_data(jax_batch)
    with pytest.raises(TypeError, match='scale_factor is None'):
        port.optimize_parameters(1)
    with pytest.raises(TypeError, match='NoneType'):
        jax_model.optimize_parameters(1)


@pytest.mark.parametrize('name', list(SYNTHETIC))
def test_synthetic_configs_parse_and_refuse_num_gpu_auto_without_a_card(name, tmp_path):
    phase, folder, stem = SYNTHETIC[name]
    path = config(phase, folder, stem + '.yml')
    opt = yaml_load(path)
    assert opt['num_gpu'] == 'auto' and opt['scale'] == 3
    published = {'registration': 'train_Registration_L2S_Square192_scratch.yml',
                 'joint': 'train_AlignResDiff_3loss_L2S_Square192.yml',
                 'joint-test': 'train_AlignResDiff_3loss_L2S_Square192.yml',
                 'srcnn': 'train_SRCNN_L2S288.yml'}[name]
    ref = yaml_load(config('train', folder, published))
    assert opt['model_type'] == ref['model_type']
    net = copy.deepcopy(ref['network_g'])
    if name.startswith('joint'):   # the LR encoder the published file leaves out
        net['lr_encoder_args'] = dict(num_in_ch=6, num_out_ch=6, num_feat=64, num_block=8)
    assert plain(opt['network_g']) == plain(net)
    if phase == 'train':
        assert opt['datasets']['train']['batch_size_per_gpu'] == \
            ref['datasets']['train']['batch_size_per_gpu']
        for key in ('use_amp', 'stage1_opt', 'stage2_opt', 'decoder_opt', 'sr_opt', 'pixel_opt'):
            assert plain(opt['train'].get(key)) == plain(ref['train'].get(key)), key
    datasets = opt['datasets'].values()
    for d in datasets:
        assert d['type'] == 'L2SSingleHMSplitDataset'
        assert {'psnr_min', 'ssim_min', 'psnr_max'} <= set(d)
    gt_sizes = {d['gt_size'] for d in datasets}
    # GT 66 for the joint model (its published image_size 64); a validation
    # GT of 216 for the registration model, whose NIQE needs two blocks a side
    assert gt_sizes == {'registration': {192, 216}, 'srcnn': {288}}.get(name, {66})
    metrics = set(opt['val']['metrics'])
    want = set(ref['val']['metrics'])
    if name.startswith('joint'):   # NIQE takes 96-pixel blocks, which GT 66 does not hold
        want = {m for m in want if not m.startswith('niqe')}
    assert metrics == want
    if torch.cuda.is_available():
        pytest.skip('the refusal is about a host without CUDA')
    entry = port_train.train_pipeline if phase == 'train' else port_test.test_pipeline
    argv = sys.argv
    sys.argv = ['x.py', '-opt', path]
    try:
        with pytest.raises(RuntimeError, match='num_gpu'):
            entry(str(tmp_path))
    finally:
        sys.argv = argv
