"""The port's GAN models (basicsr4rs_torch/models/srgan_model.py,
esrgan_model.py) against the JAX package's: one training step of
``SRGANModel`` and of ``ESRGANModel`` from the same ``.pth`` files
(MSRResNet at 8 features, ``VGGStyleDiscriminator`` at 8 features on
128x128, an L1 pixel loss, a VGG perceptual loss on a random
torchvision-format VGG19, the vanilla GAN loss, EMA) on the same batch:
the logged losses, the generator, its EMA, the discriminator and its
BatchNorm running statistics after the step. Float32 on the CPU.

Tolerances: losses within 1e-5 relative. After a step, each parameter
tensor's update (the running statistics: their change) within 1e-3 of the
JAX package's largest, plus 1e-6 of the tensor's scale for the rounding of
the sum (gradients of float32 sums in another order, through BatchNorm over
batches of 2)."""

import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.discriminator_arch import VGGStyleDiscriminator
from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.models import srgan_model as jax_srgan_model

from test_torch_gan_losses import write_vgg19

TOL = 1e-5
G_NET = dict(type='MSRResNet', num_in_ch=3, num_out_ch=3, num_feat=8, num_block=1, upscale=4)
D_NET = dict(type='VGGStyleDiscriminator', num_in_ch=3, num_feat=8)


def nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def gan_opt(model_type, tmp, optim, **train):
    opt = {'name': 'gan', 'model_type': model_type, 'scale': 4, 'num_gpu': 0, 'manual_seed': 0,
           'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
           'network_g': dict(G_NET), 'network_d': dict(D_NET),
           'path': {'pretrain_network_g': str(tmp / 'g.pth'), 'strict_load_g': True,
                    'pretrain_network_d': str(tmp / 'd.pth'), 'strict_load_d': False,
                    'models': str(tmp / 'models'), 'training_states': str(tmp / 'states')},
           'train': {'ema_decay': 0.9, 'net_d_iters': 1, 'net_d_init_iters': 0,
                     'optim_g': dict(optim), 'optim_d': dict(optim),
                     'scheduler': {'type': 'MultiStepLR', 'milestones': [50], 'gamma': 0.5},
                     'total_iter': 100, 'warmup_iter': -1,
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'},
                     'perceptual_opt': {'type': 'PerceptualLoss', 'layer_weights': {'conv2_2': 1},
                                        'criterion': 'l1', 'perceptual_weight': 1.0,
                                        'style_weight': 0, 'pretrain_path': str(tmp / 'vgg.pth')},
                     'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla', 'real_label_val': 1.0,
                                 'fake_label_val': 0.0, 'loss_weight': 0.5}},
           'val': {'val_freq': 100}}
    opt['train'].update(train)
    return opt


def jax_model(opt):
    """The JAX package's model, its networks initialised by one compiled
    function each (on the CPU it initialises op by op, which costs more
    here than the compilation)."""
    with mock.patch.object(jax_sr_model, 'jit_init', jax.jit), \
            mock.patch.object(jax_srgan_model, 'jit_init', jax.jit):
        return jax_build_model(copy.deepcopy(opt))


def write_inputs(tmp):
    """Random G and D ``.pth`` files (the D's parameters only: the JAX
    package reads no running statistics from a checkpoint, and both start
    from mean 0, variance 1) and a VGG19 to ``conv2_2``."""
    torch.manual_seed(0)
    g = MSRResNet(**{k: v for k, v in G_NET.items() if k != 'type'})
    d = VGGStyleDiscriminator(num_feat=8)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            p.normal_(0, p[0].numel()**-0.5 if p.dim() > 1 else 0.1, generator=gen)
    torch.save({'params': g.state_dict()}, tmp / 'g.pth')
    torch.save({'params': dict(d.named_parameters())}, tmp / 'd.pth')
    write_vgg19(tmp / 'vgg.pth', convs=4)


def batch(seed=2):
    rng = np.random.RandomState(seed)
    return {'lq': torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32)),
            'gt': torch.from_numpy(rng.rand(2, 3, 128, 128).astype(np.float32))}


def jax_state_dict(tree, rules=None, stats=None):
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    stats = None if stats is None else jax.tree_util.tree_map(np.asarray, jax.device_get(stats))
    return jax_params_to_state_dict(tree, rules, stats)


def assert_params_close(port_sd, jax_sd, before, what):
    """Each tensor's update (or value, where ``before`` has none) within
    1e-3 of the JAX package's largest, plus 1e-6 of the tensor's scale for
    the float32 rounding of the sum."""
    for key, value in port_sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        got, want = value.double(), jax_sd[key].double()
        base = before[key].double() if key in before else torch.zeros_like(want)
        biggest = (want - base).abs().max().item()
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * biggest + 1e-6 * want.abs().max().item(), f'{what} {key}: {err:.3e}'


@pytest.mark.parametrize('model_type', ['SRGANModel', 'ESRGANModel'])
def test_gan_step_matches_jax(model_type, tmp_path):
    """One step from the same weights and batch. The discriminator's
    statistics after it are those of the D phase alone (real, then fake
    from the real-updated statistics): the G phase's passes, and ESRGAN's
    constant fake pass, keep them."""
    write_inputs(tmp_path)
    opt = gan_opt(model_type, tmp_path, {'type': 'SGD', 'lr': 0.05})
    port = port_build_model(copy.deepcopy(opt))
    ref = jax_model(opt)
    g_before = {k: v.clone() for k, v in port.net_g.state_dict().items()}
    d_before = {k: v.clone() for k, v in port.net_d.state_dict().items()}
    data = batch()
    port.feed_data(data)
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    ref.feed_data({k: nhwc(v) for k, v in data.items()})
    ref.optimize_parameters(1)

    got, want = port.get_current_log(), ref.get_current_log()
    assert list(got) == list(want) == ['l_g_pix', 'l_g_percep', 'l_g_gan', 'l_g_total',
                                       'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL, abs=1e-7), key
    assert got['l_g_percep'] > 1e-2 * got['l_g_total']   # the VGG term is not vanishing

    d_rules = VGGStyleDiscriminator.JAX_KEY_RULES
    assert_params_close(port.net_g.state_dict(), jax_state_dict(ref.state.params), g_before, 'G')
    assert_params_close(port.net_g_ema.state_dict(), jax_state_dict(ref.state.ema_params),
                        g_before, 'EMA')
    assert_params_close(port.net_d.state_dict(),
                        jax_state_dict(ref.d_state.params, d_rules, ref.d_state.stats),
                        d_before, 'D')
    for key, value in port.net_d.state_dict().items():
        if 'running' in key:   # moved once by each D-phase pass
            assert not torch.equal(value, d_before[key]), key
            assert port.net_d.get_buffer(key.rsplit('.', 1)[0] + '.num_batches_tracked') == 2
