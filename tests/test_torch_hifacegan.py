"""The port's HiFaceGAN slice against the JAX package's, on the CPU:
``nearest_resize_to``, SPADE, LIP (basicsr4rs_torch/archs/
hifacegan_util.py), ``HiFaceGAN`` with spectral SPADE blocks and
``HiFaceGANDiscriminator`` (archs/hifacegan_arch.py), ``GANFeatLoss``
(losses/basic_loss.py) and one ``HiFaceGANModel`` step
(models/hifacegan_model.py), at 4 features on 64x64 faces; and the
HiFaceGAN option files. The JAX networks' parameters go to the port through
``jax_convert`` and the architectures' ``JAX_KEY_RULES``; every parameter is
redrawn non-zero.

Tolerances, float32: the networks' outputs 1e-5 of their largest magnitude
(2e-5 through the exact spectral norm's eigensolver; 1e-4 for the whole
generator, whose own float32 rounding reads 3.5e-5: the port in float32
against itself in float64); the losses 1e-5
relative; after one SGD step each parameter tensor's update within 1e-3 of
the JAX package's largest, plus 1e-6 of the tensor's scale.
"""

import copy
from os import path as osp
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.hifacegan_arch import HiFaceGAN, HiFaceGANDiscriminator, SPADEGenerator
from basicsr4rs_torch.archs.hifacegan_util import SPADE, LIPEncoder, nearest_resize_to
from basicsr4rs_torch.losses.basic_loss import GANFeatLoss
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils import registry as port_registry
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.archs import hifacegan_arch as jax_arch
from basicsr4rs_tpu.archs import hifacegan_util as jax_util
from basicsr4rs_tpu.losses.basic_loss import GANFeatLoss as JaxGANFeatLoss
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.models import srgan_model as jax_srgan_model
from basicsr4rs_tpu.parallel import mesh as jax_mesh

from test_torch_esrgan import TOL, assert_params_close
from test_torch_gan_losses import write_vgg19
from test_torch_resshift import _shapes_only

ROOT = osp.join(osp.dirname(__file__), '..')
G_KW = dict(num_in_ch=3, num_feat=4, crop_size=64, norm_g='spectralspadebatch3x3', is_train=False)
D_KW = dict(num_in_ch=3, num_out_ch=3, conditional_d=True, num_feat=4, norm_d='spectralinstance')
SYNTHETIC = {'options/train/HiFaceGAN/train_hifacegan_synthetic.yml':
             'options/train/HiFaceGAN/train_hifacegan.yml',
             'options/test/HiFaceGAN/test_hifacegan_synthetic.yml':
             'options/test/HiFaceGAN/test_hifacegan.yml',
             'options/test/HiFaceGAN/test_hifacegan_woGT_synthetic.yml':
             'options/test/HiFaceGAN/test_hifacegan_woGT.yml'}


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2), order='C'))


def nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def randomized(params, seed):
    """Every leaf redrawn: kernels at He scale (fan-in the product of all
    but the last axis), the rest (biases, norm scales) N(0, 0.3^2) about
    their init (1 for a GroupNorm scale)."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = getattr(path[-1], 'key', '')
        if name == 'kernel':
            return (rng.randn(*a.shape) * (2 / np.prod(a.shape[:-1]))**0.5).astype(np.float32)
        return (rng.randn(*a.shape) * 0.3 + (name == 'scale')).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


def load_port(net, params, allowed_missing=()):
    missing, unexpected = net.load_state_dict(
        jax_params_to_state_dict(params, getattr(type(net), 'JAX_KEY_RULES', None)), strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith(allowed_missing) for k in missing), missing
    return net


def assert_close(got, want, tol=1e-5, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f'{what}: {err:.3e}'


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize('src, dst', [((7, 5), (16, 9)), ((16, 12), (5, 7)), ((9, 9), (9, 9)),
                                      ((3, 4), (12, 8))])
def test_nearest_resize_to_matches_jax(src, dst):
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    np.testing.assert_array_equal(nhwc(nearest_resize_to(nchw(x), dst)),
                                  np.asarray(jax_util.nearest_resize_to(jnp.asarray(x), dst)))


@pytest.mark.parametrize('config', ['spadebatch3x3', 'spadeinstance3x3', 'spadesyncbatch3x3',
                                    'spadebatch5x5'])
def test_spade_matches_jax(config):
    """SPADE's batch norm by the batch's statistics, in eval mode too."""
    rng = np.random.RandomState(1)
    x, seg = rng.randn(2, 6, 10, 8).astype(np.float32), rng.rand(2, 23, 17, 3).astype(np.float32)
    net = jax_util.SPADE(config, 8, 3)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, seg)['params'], 2)
    port = load_port(SPADE(config, 8, 3), params).eval()
    with torch.no_grad():
        got = port(nchw(x), nchw(seg))
    assert_close(nhwc(got), net.apply({'params': params}, x, seg), what=config)


def test_lip_encoder_matches_jax():
    """Three LIP halvings (3x3 / 2 importance pooling, the gate's affine
    instance norm) on a 40x40 map."""
    x = np.random.RandomState(3).rand(2, 40, 40, 3).astype(np.float32)
    net = jax_util.LIPEncoder(3, 4, 5, 5, 3)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), x)['params'], 4)
    port = load_port(LIPEncoder(3, 4, 5, 5, 3), params)
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (2, 32, 5, 5)
    assert_close(nhwc(got), net.apply({'params': params}, x))


@pytest.fixture(scope='module')
def face():
    return np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)


def test_hifacegan_matches_jax(face):
    """The LIP encoder and spectral SPADE blocks (batch norm), all four up
    blocks (``is_train: false``); BasicSR's ``fc`` and first three
    ``to_rgbs``, which this configuration never runs, are absent from the
    JAX parameters."""
    net = jax_arch.HiFaceGAN(**G_KW)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), face)['params'], 6)
    port = load_port(HiFaceGAN(**G_KW), params,
                     ('fc.', 'to_rgbs.0.', 'to_rgbs.1.', 'to_rgbs.2.')).eval()
    with torch.no_grad():
        got = port(nchw(face))
    assert_close(nhwc(got), jax.jit(net.apply)({'params': params}, face), 1e-4)


@pytest.mark.parametrize('mode, n', [('progressive', 3), ('one_plug', 2), ('one_ablate', 5)])
def test_spade_generator_guidance_matches_jax(face, mode, n):
    """``SPADEGenerator`` (its ``fc`` encoder, instance SPADE, no spectral
    norm) with two guides mixed block by block."""
    kwargs = dict(num_in_ch=3, num_feat=4, crop_size=64, norm_g='spadeinstance3x3',
                  is_train=False)
    net = jax_arch.SPADEGenerator(**kwargs)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), face)['params'], 11)
    port = load_port(SPADEGenerator(**kwargs), params, ('to_rgbs.0.', 'to_rgbs.1.',
                                                        'to_rgbs.2.'))
    seg = face[::-1].copy()
    with torch.no_grad():
        got = port.mixed_guidance_forward(nchw(face), nchw(seg), n=n, mode=mode)
    want = jax.jit(lambda p, x, s: net.apply({'params': p}, x, s, n=n, mode=mode,
                                             method=net.mixed_guidance_forward))(params, face, seg)
    assert_close(nhwc(got), want, 1e-4, mode)


def test_hifacegan_discriminator_matches_jax(face):
    """Two scales of spectral PatchGANs on the conditional pair, every
    stage's output."""
    pair = np.concatenate([face, face[::-1]], axis=-1)
    net = jax_arch.HiFaceGANDiscriminator(**D_KW)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), pair)['params'], 7)
    port = load_port(HiFaceGANDiscriminator(**D_KW), params)
    with torch.no_grad():
        got = port(nchw(pair))
    want = jax.jit(net.apply)({'params': params}, pair)
    assert len(got) == len(want) == 2
    for i, (g_scale, w_scale) in enumerate(zip(got, want)):
        assert len(g_scale) == len(w_scale) == 5
        for j, (g, w) in enumerate(zip(g_scale, w_scale)):
            assert_close(nhwc(g), w, 2e-5, f'scale {i} stage {j}')


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'charbonnier'])
def test_gan_feat_loss_matches_jax(criterion):
    rng = np.random.RandomState(8)
    shapes = [(2, 5, 5, 3), (2, 3, 3, 4), (2, 2, 2, 1)]
    fake = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(2)]
    real = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(2)]
    want = JaxGANFeatLoss(criterion, loss_weight=10.)(
        [[jnp.asarray(t) for t in s] for s in fake], [[jnp.asarray(t) for t in s] for s in real])
    got = GANFeatLoss(criterion, loss_weight=10.)([[nchw(t) for t in s] for s in fake],
                                                  [[nchw(t) for t in s] for s in real])
    assert got.item() == pytest.approx(float(want), rel=1e-6)


# ------------------------------------------------------------------- model
def model_opt(tmp):
    opt = yaml_load(osp.join(ROOT, 'options/train/HiFaceGAN/train_hifacegan.yml'))
    opt.update(num_gpu=1, is_train=True, dist=False, rank=0, world_size=1)
    opt['network_g'].update(num_feat=4, crop_size=64)
    opt['network_d'].update(num_feat=4)
    opt['path'].update(models=str(tmp / 'models'), training_states=str(tmp / 'states'))
    train = opt['train']
    train['optim_g'] = {'type': 'SGD', 'lr': 0.05}
    train['optim_d'] = {'type': 'SGD', 'lr': 0.05}
    train['perceptual_opt'].update(layer_weights={'relu1_1': 0.5, 'relu2_1': 1.0},
                                   pretrain_path=str(tmp / 'vgg.pth'))
    train['pixel_opt'] = {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}
    return opt


def test_model_step_matches_jax(tmp_path, face):
    """One step of the published training configuration at 4 features on
    64x64 (SGD, a pixel loss added, the perceptual loss to relu2_1): the
    logs (lsgan G and D terms, feature matching, perceptual, pixel) and
    every parameter's update of G and D."""
    write_vgg19(tmp_path / 'vgg.pth', convs=4)
    opt = model_opt(tmp_path)
    one_device = mock.patch('basicsr4rs_tpu.models.base_model.create_mesh',
                            lambda o: jax_mesh.create_mesh(o, jax.devices()[:1]))
    with mock.patch.object(jax_sr_model, 'jit_init', _shapes_only), one_device, \
            mock.patch.object(jax_srgan_model, 'jit_init', _shapes_only):
        ref = jax_build_model(copy.deepcopy(opt))
    g = randomized(jax.device_get(ref.state.params), 9)
    d = randomized(jax.device_get(ref.d_state.params), 10)
    ref.state = ref.state.replace(params=g)
    ref.d_state = ref.d_state.replace(params=d)
    port_opt = copy.deepcopy(opt)
    port_opt['num_gpu'] = 0
    port = port_build_model(port_opt)
    load_port(port.net_g, g, ('fc.', 'to_rgbs.0.', 'to_rgbs.1.', 'to_rgbs.2.'))
    load_port(port.net_d, d)
    g_before = {k: v.clone() for k, v in port.net_g.state_dict().items()}
    d_before = {k: v.clone() for k, v in port.net_d.state_dict().items()}
    lq = (face * 0.5 + 0.25).astype(np.float32)
    data = {'lq': lq, 'gt': face}
    ref.feed_data(data)
    ref.optimize_parameters(1)
    port.feed_data({k: nchw(v) for k, v in data.items()})
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    got, want = port.get_current_log(), ref.get_current_log()
    assert list(got) == list(want) == ['l_g_pix', 'l_g_percep', 'l_g_gan', 'l_g_feat',
                                       'l_g_total', 'l_d_real', 'l_d_fake']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL, abs=1e-7), key
    unused = ('fc.', 'to_rgbs.0.', 'to_rgbs.1.', 'to_rgbs.2.')
    for what, net, tree, before in (('G', port.net_g, ref.state.params, g_before),
                                    ('D', port.net_d, ref.d_state.params, d_before)):
        want_sd = as_port(net, tree, unused)
        assert_params_close({k: v for k, v in net.state_dict().items()
                             if not k.startswith(unused)}, want_sd, before, what)


def as_port(net, tree, allowed_missing=()):
    """The JAX parameters ``tree`` as the port's state_dict of ``net``."""
    return load_port(copy.deepcopy(net), jax.tree_util.tree_map(np.asarray, jax.device_get(tree)),
                     allowed_missing).state_dict()


def test_ema_is_refused(tmp_path):
    opt = model_opt(tmp_path)
    opt.update(num_gpu=0)
    opt['train']['ema_decay'] = 0.999
    write_vgg19(tmp_path / 'vgg.pth', convs=4)
    with pytest.raises(NotImplementedError):
        port_build_model(opt)


# ------------------------------------------------------------ option files
@pytest.mark.parametrize('path', sorted(SYNTHETIC) + sorted(SYNTHETIC.values()))
def test_option_file_names_only_registered_types(path):
    opt = yaml_load(osp.join(ROOT, path))
    reg = port_registry
    reg.MODEL_REGISTRY.get(opt['model_type'])
    for key, net in opt.items():
        if key.startswith('network_'):
            reg.ARCH_REGISTRY.get(net['type'])
    for ds in opt['datasets'].values():
        reg.DATASET_REGISTRY.get(ds['type'])
    for key, loss in (opt.get('train') or {}).items():
        if key.endswith('_opt'):
            reg.LOSS_REGISTRY.get(loss['type'])
    for metric in ((opt.get('val') or {}).get('metrics') or {}).values():
        reg.METRIC_REGISTRY.get(metric['type'])


@pytest.mark.parametrize('synthetic', sorted(SYNTHETIC))
def test_synthetic_config_is_the_published_one(synthetic):
    """Every key as published but the data roots, the trained generator's
    path (test files), four iterations and the VGG19 path (training)."""
    got, want = (yaml_load(osp.join(ROOT, p)) for p in (synthetic, SYNTHETIC[synthetic]))
    for opt, synthetic_roots in ((got, True), (want, False)):
        for ds in opt['datasets'].values():
            for key in ('dataroot_gt', 'dataroot_lq'):
                if key in ds:
                    root = ds.pop(key)
                    assert not synthetic_roots or root.startswith('datasets/HiFaceGAN_synthetic/')
    if 'train' in got:
        assert got['train'].pop('total_iter') == 4
        want['train'].pop('total_iter')
        assert got['train']['perceptual_opt'].pop('pretrain_path') == \
            'results/chip_smoke/vgg19.pth'
    else:
        assert got['path'].pop('pretrain_network_g') == \
            'experiments/HiFaceGAN_SR4x_train/models/net_g_latest.pth'
        want['path'].pop('pretrain_network_g')
    assert got == want
