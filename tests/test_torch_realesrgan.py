"""The port's Real-ESRGAN dataset and models against the JAX package's, on
the CPU: ``RealESRGANDataset`` items (basicsr4rs_torch/data/
realesrgan_dataset.py), one ``RealESRNetModel`` and one ``RealESRGANModel``
step (models/realesrnet_model.py, realesrgan_model.py) from the same
``.pth`` files on the same batch, the on-device synthesis inside
``feed_data``, and the Real-ESRGAN / LDL option files.

The model steps take the batch as synthesised (``lq``, ``gt``; no
kernels), so both packages make ``gt_usm`` with their USM and train on it:
RRDBNet at 8 features (1 block, growth 4), ``UNetDiscriminatorSN`` at 4,
GT 32x32, an L1 pixel loss, a VGG perceptual loss on a random
torchvision-format VGG19, the vanilla GAN loss, EMA 0.9, SGD. Tolerances
as ``test_torch_esrgan.py``: losses within 1e-5 relative; each parameter
tensor's update within 1e-3 of the JAX package's largest, plus 1e-6 of the
tensor's scale. Dataset items: equal.
"""

import copy
from os import path as osp
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.discriminator_arch import UNetDiscriminatorSN
from basicsr4rs_torch.archs.rrdbnet_arch import RRDBNet
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils import registry as port_registry
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.models import srgan_model as jax_srgan_model

from test_torch_esrgan import TOL, assert_params_close, jax_state_dict, nhwc
from test_torch_gan_losses import write_vgg19
from test_torch_resshift import _shapes_only

ROOT = osp.join(osp.dirname(__file__), '..')
PUBLISHED = ['options/train/RealESRGAN/train_realesrnet_x4plus.yml',
             'options/train/RealESRGAN/train_realesrnet_x2plus.yml',
             'options/train/RealESRGAN/train_realesrgan_x4plus.yml',
             'options/train/RealESRGAN/train_realesrgan_x2plus.yml',
             'options/train/LDL/train_LDL_Real_x4.yml']
SYNTHETIC = {'options/train/RealESRGAN/train_realesrnet_x4plus_synthetic.yml': PUBLISHED[0],
             'options/train/RealESRGAN/train_realesrgan_x4plus_synthetic.yml': PUBLISHED[2]}
G_NET = dict(type='RRDBNet', num_in_ch=3, num_out_ch=3, num_feat=8, num_block=1, num_grow_ch=4)
D_NET = dict(type='UNetDiscriminatorSN', num_in_ch=3, num_feat=4, skip_connection=True)


def published(path):
    return yaml_load(osp.join(ROOT, path))


# ------------------------------------------------------------- option files
@pytest.mark.parametrize('path', PUBLISHED + sorted(SYNTHETIC))
def test_option_file_names_only_registered_types(path):
    opt = published(path)
    reg = port_registry
    reg.MODEL_REGISTRY.get(opt['model_type'])
    for key, net in opt.items():
        if key.startswith('network_'):
            reg.ARCH_REGISTRY.get(net['type'])
    for ds in opt['datasets'].values():
        reg.DATASET_REGISTRY.get(ds['type'])
    for key, loss in opt['train'].items():
        if key.endswith('_opt') and key not in ('optim_g', 'optim_d'):
            reg.LOSS_REGISTRY.get(loss['type'])
    for metric in ((opt.get('val') or {}).get('metrics') or {}).values():
        reg.METRIC_REGISTRY.get(metric['type'])


@pytest.mark.parametrize('synthetic', sorted(SYNTHETIC))
def test_synthetic_config_is_the_published_one(synthetic):
    """Every key as published but the GT tree and its meta-info file, a
    null ``pretrain_network_g``, 16 iterations, the added validation set and
    its PSNR, and the GAN file's VGG19 path."""
    got, want = published(synthetic), published(SYNTHETIC[synthetic])
    train = got['datasets']['train']
    assert train.pop('dataroot_gt') == 'datasets/RealESRGAN_synthetic/GT'
    assert train.pop('meta_info') == 'datasets/RealESRGAN_synthetic/meta_info.txt'
    for key in ('dataroot_gt', 'meta_info'):
        want['datasets']['train'].pop(key)
    assert got['datasets'].pop('val')['type'] == 'PairedImageDataset'
    assert got['path'].pop('pretrain_network_g') is None
    want['path'].pop('pretrain_network_g')
    assert got['train'].pop('total_iter') == 16
    want['train'].pop('total_iter')
    assert set(got.pop('val')['metrics']) == {'psnr'}
    if 'perceptual_opt' in got['train']:
        assert got['train']['perceptual_opt'].pop('pretrain_path') == 'results/chip_smoke/vgg19.pth'
    assert got == want
    assert want['queue_size'] % want['datasets']['train']['batch_size_per_gpu'] == 0


# ------------------------------------------------------------------ dataset
@pytest.fixture(scope='module')
def gt_tree(tmp_path_factory):
    """GT images under and over the crop size on each side, and a meta-info
    file listing them in another order."""
    root = tmp_path_factory.mktemp('realesrgan_gt')
    (root / 'GT').mkdir()
    rs = np.random.RandomState(1)
    names = []
    for i, (h, w) in enumerate([(40, 56), (64, 72), (50, 50), (80, 44)]):
        names.append(f'{i}.png')
        cv2.imwrite(str(root / 'GT' / names[-1]), (rs.rand(h, w, 3) * 255).astype(np.uint8))
    (root / 'meta_info.txt').write_text(''.join(f'{n} (x,x,3)\n' for n in reversed(names)))
    return root


def dataset_opt(root, meta):
    opt = copy.deepcopy(published(PUBLISHED[0])['datasets']['train'])
    opt.update(name='gt', phase='train', scale=4, dataroot_gt=str(root / 'GT'), crop_pad_size=48,
               use_rot=True, manual_seed=3, meta_info=str(root / 'meta_info.txt') if meta else None)
    return opt


@pytest.mark.parametrize('meta', [True, False], ids=['meta_info', 'folder'])
def test_dataset_items_match_jax(gt_tree, meta):
    """Eight items in a row (the list twice): the same crops, flips and
    kernels from the same seed."""
    port = port_build_dataset(dataset_opt(gt_tree, meta))
    ref = jax_build_dataset(dataset_opt(gt_tree, meta))
    assert [osp.basename(p) for p in port.paths] == [osp.basename(p) for p in ref.paths]
    for index in list(range(len(port))) * 2:
        got, want = port[index], ref[index]
        assert got['gt'].shape == (3, 48, 48)
        np.testing.assert_array_equal(got['gt'].numpy().transpose(1, 2, 0), want['gt'])
        for key in ('kernel1', 'kernel2', 'sinc_kernel'):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        assert got['gt_path'] == want['gt_path']


@pytest.fixture(scope='module')
def pair_tree(tmp_path_factory):
    """LQ images and their GT at 4x under the same names, and a meta-info
    file of ``gt, lq`` lines in another order."""
    root = tmp_path_factory.mktemp('realesrgan_pairs')
    (root / 'GT').mkdir()
    (root / 'LQ').mkdir()
    rs = np.random.RandomState(2)
    names = []
    for i, (h, w) in enumerate([(10, 12), (16, 9), (12, 12)]):
        names.append(f'{i}.png')
        for sub, scale in (('GT', 4), ('LQ', 1)):
            cv2.imwrite(str(root / sub / names[-1]),
                        (rs.rand(h * scale, w * scale, 3) * 255).astype(np.uint8))
    (root / 'meta_info.txt').write_text(''.join(f'{n}, {n}\n' for n in reversed(names)))
    return root


@pytest.mark.parametrize('mode', ['meta_info', 'folder', 'mean_std'])
def test_paired_dataset_items_match_jax(pair_tree, mode):
    """``RealESRGANPairedDataset``, six train items in a row (the list
    twice): the same aligned crops and flips from the one generator of the
    same seed, bit for bit; ``mean_std`` normalises both images."""
    opt = dict(type='RealESRGANPairedDataset', name='pairs', phase='train', scale=4, gt_size=32,
               use_hflip=True, use_rot=True, manual_seed=5, dataroot_gt=str(pair_tree / 'GT'),
               dataroot_lq=str(pair_tree / 'LQ'),
               meta_info=str(pair_tree / 'meta_info.txt') if mode == 'meta_info' else None)
    if mode == 'mean_std':
        opt.update(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])
    port, ref = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert [p['gt_path'] for p in port.paths] == [p['gt_path'] for p in ref.paths]
    assert len(port) == 3
    for index in list(range(len(port))) * 2:
        got, want = port[index], ref[index]
        assert got['gt'].shape == (3, 32, 32) and got['lq'].shape == (3, 8, 8)
        for key in ('gt', 'lq'):
            np.testing.assert_array_equal(got[key].numpy().transpose(1, 2, 0), want[key])
        assert (got['gt_path'], got['lq_path']) == (want['gt_path'], want['lq_path'])
    if mode == 'mean_std':
        assert got['gt'].min() < 0


# ------------------------------------------------------------------- models
def model_opt(model_type, tmp, **flags):
    opt = published(PUBLISHED[2] if model_type == 'RealESRGANModel' else PUBLISHED[0])
    opt.pop('datasets')
    opt.update(name='realesrgan', model_type=model_type, num_gpu=0, manual_seed=0, is_train=True,
               dist=False, rank=0, world_size=1, gt_size=32, queue_size=4,
               network_g=dict(G_NET), val={'val_freq': 100}, **flags)
    opt['path'] = {'pretrain_network_g': str(tmp / 'g.pth'), 'strict_load_g': True,
                   'pretrain_network_d': str(tmp / 'd.pth'), 'strict_load_d': True,
                   'models': str(tmp / 'models'), 'training_states': str(tmp / 'states')}
    train = opt['train']
    train.update(ema_decay=0.9, optim_g={'type': 'SGD', 'lr': 0.05}, total_iter=100,
                 scheduler={'type': 'MultiStepLR', 'milestones': [50], 'gamma': 0.5})
    if model_type == 'RealESRGANModel':
        opt['network_d'] = dict(D_NET)
        train['optim_d'] = {'type': 'SGD', 'lr': 0.05}
        train['perceptual_opt'].update(layer_weights={'conv2_2': 1},
                                       pretrain_path=str(tmp / 'vgg.pth'))
    return opt


def jax_model(opt):
    """The JAX package's model with its variables as zeros of their shapes:
    every one of them then comes from the ``.pth`` files."""
    with mock.patch.object(jax_sr_model, 'jit_init', _shapes_only), \
            mock.patch.object(jax_srgan_model, 'jit_init', _shapes_only):
        return jax_build_model(copy.deepcopy(opt))


def write_weights(tmp):
    gen = torch.Generator().manual_seed(1)
    g = RRDBNet(**{k: v for k, v in G_NET.items() if k != 'type'})
    d = UNetDiscriminatorSN(**{k: v for k, v in D_NET.items() if k != 'type'})
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            p.normal_(0, p[0].numel()**-0.5 if p.dim() > 1 else 0.1, generator=gen)
    torch.save({'params': g.state_dict()}, tmp / 'g.pth')
    torch.save({'params': dict(d.named_parameters())}, tmp / 'd.pth')
    write_vgg19(tmp / 'vgg.pth', convs=4)


def synthesised_batch(seed=2):
    rng = np.random.RandomState(seed)
    return {'lq': torch.from_numpy(rng.rand(2, 3, 8, 8).astype(np.float32)),
            'gt': torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))}


def one_step(opt):
    """Both packages' models from the same files, one step on one batch."""
    port, ref = port_build_model(copy.deepcopy(opt)), jax_model(opt)
    before = {'g': {k: v.clone() for k, v in port.net_g.state_dict().items()}}
    if hasattr(port, 'net_d'):
        before['d'] = {k: v.clone() for k, v in port.net_d.state_dict().items()}
    data = synthesised_batch()
    port.feed_data(data)
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    ref.feed_data({k: nhwc(v) for k, v in data.items()})
    ref.optimize_parameters(1)
    np.testing.assert_allclose(nhwc(port.gt_usm), ref.batch['gt_usm'], rtol=0, atol=2e-6)
    got, want = port.get_current_log(), ref.get_current_log()
    assert list(got) == list(want)
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL, abs=1e-7), key
    assert_params_close(port.net_g.state_dict(), jax_state_dict(ref.state.params), before['g'], 'G')
    assert_params_close(port.net_g_ema.state_dict(), jax_state_dict(ref.state.ema_params),
                        before['g'], 'EMA')
    return port, ref, before, got


def test_realesrnet_step_matches_jax(tmp_path):
    """The L1 loss against ``gt_usm`` (the published ``gt_usm: true``)."""
    write_weights(tmp_path)
    port, _, _, logs = one_step(model_opt('RealESRNetModel', tmp_path))
    assert list(logs) == ['l_pix']
    assert port.loss_targets()[0] is port.gt_usm
    assert float((port.gt_usm - port.gt).abs().mean()) > 1e-3   # the targets differ


@pytest.mark.parametrize('flags', [
    dict(l1_gt_usm=False, percep_gt_usm=True, gan_gt_usm=True, ldl=True),
    dict(l1_gt_usm=True, percep_gt_usm=False, gan_gt_usm=False, ldl=False)],
    ids=['plain L1, USM perceptual and D, LDL', 'USM L1, plain perceptual and D, no LDL'])
def test_realesrgan_step_matches_jax(flags, tmp_path):
    """Each ``*_gt_usm`` flag both ways between the two cases, with and
    without LDL (whose artifact map reads the plain GT)."""
    write_weights(tmp_path)
    flags = dict(flags)
    opt = model_opt('RealESRGANModel', tmp_path, **{k: v for k, v in flags.items() if k != 'ldl'})
    if flags['ldl']:
        opt['train']['ldl_opt'] = {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}
    port, ref, before, logs = one_step(opt)
    assert list(logs) == ['l_g_pix'] + ['l_g_ldl'] * flags['ldl'] + [
        'l_g_percep', 'l_g_gan', 'l_g_total', 'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake']
    targets = port.loss_targets()
    for target, flag in zip(targets, ('l1_gt_usm', 'percep_gt_usm', 'gan_gt_usm')):
        assert target is (port.gt_usm if flags[flag] else port.gt)
    assert_params_close(port.net_d.state_dict(),
                        jax_state_dict(ref.d_state.params, UNetDiscriminatorSN.JAX_KEY_RULES),
                        before['d'], 'D')


def test_feed_data_synthesises_crops_and_pools_on_the_model_device(tmp_path):
    """Three fed batches of 2 with a queue of 4: the pool fills with the
    first two (passed through) and swaps at the third; the LQ is the
    crop's, ``gt_usm`` the sharpened GT that came out of the pool; a
    batch without kernels is fed as it is."""
    from basicsr4rs_torch.data.degradations import bivariate_Gaussian, circular_lowpass_kernel
    write_weights(tmp_path)
    model = port_build_model(model_opt('RealESRNetModel', tmp_path))
    k = torch.from_numpy(np.stack([bivariate_Gaussian(21, 2.0, 2.0, 0)] * 2).astype(np.float32))
    sinc = torch.from_numpy(np.stack([circular_lowpass_kernel(np.pi / 2, 13, pad_to=21)] * 2)
                            .astype(np.float32))
    rng = np.random.RandomState(0)
    seen = []
    for step in range(3):
        gt = torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32))
        model.feed_data({'gt': gt, 'kernel1': k, 'kernel2': k, 'sinc_kernel': sinc})
        assert model.lq.shape == (2, 3, 8, 8) and model.gt.shape == (2, 3, 32, 32)
        assert torch.equal(model.gt_usm, model.degrader.usm(model.gt))
        seen.append(model.gt.clone())
    assert (model.pool.ptr, model.pool.swaps) == (4, 1)
    assert 0 <= float(model.lq.min()) and float(model.lq.max()) <= 1
    # the swapped-out pair is one of the stored ones
    stored = torch.cat(seen[:2])
    assert all(any(torch.equal(g, s) for s in stored) for g in model.gt)
    plain = synthesised_batch()
    model.feed_data(plain)
    assert torch.equal(model.lq, plain['lq']) and model.pool.swaps == 1
