"""The perceptual branches of the port's ``SRModel`` and
``L2SSingleHMModel`` (basicsr4rs_torch/models/sr_model.py,
srrs_l2shm_model.py) against the JAX package's: one SGD step from the same
``.pth`` on the same batch, with a pixel loss and a VGG perceptual loss and
its style term (a random torchvision-format VGG19 that both packages read);
the logged losses within 1e-5 and every parameter's update within 1e-3 of
the largest (tests/test_torch_esrgan.py's rule). Float32 on the CPU."""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.archs.swinir_stylecnn_arch import SwinIR_StyleCNN
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_tpu.archs import swinir_stylecnn_arch as jax_stylecnn
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model

from test_torch_esrgan import TOL, assert_params_close, jax_state_dict, nhwc
from test_torch_gan_losses import write_vgg19
from test_torch_resshift import _nonzero_
from test_torch_rs_models import STYLECNN_TORCH_KEY_RULES

PERCEPTUAL = {'type': 'PerceptualLoss', 'layer_weights': {'conv1_2': 0.5, 'conv2_1': 1.0},
              'criterion': 'l1', 'perceptual_weight': 0.7, 'style_weight': 30.}


def model_opt(model_type, network_g, tmp, **top):
    return {'name': 'percep', 'model_type': model_type, 'scale': 4, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': copy.deepcopy(network_g),
            'path': {'pretrain_network_g': str(tmp / 'g.pth'), 'strict_load_g': True},
            'train': {'ema_decay': 0, 'optim_g': {'type': 'SGD', 'lr': 0.05},
                      'scheduler': {'type': 'MultiStepLR', 'milestones': [100], 'gamma': 0.5},
                      'total_iter': 10,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'},
                      'perceptual_opt': dict(PERCEPTUAL, pretrain_path=str(tmp / 'vgg.pth'))},
            'val': {'val_freq': 10}, **top}


def jax_model(opt, dummy):
    """The JAX model of ``opt``, its network initialised by one compiled
    function on a ``dummy`` map of the test's shape."""
    with mock.patch.object(jax_sr_model, 'jit_init', jax.jit), \
            mock.patch.object(jax_sr_model.SRModel, '_dummy_input',
                              lambda self: jnp.zeros(dummy, jnp.float32)), \
            mock.patch.object(jax_stylecnn.SwinIR_StyleCNN, 'TORCH_KEY_RULES',
                              STYLECNN_TORCH_KEY_RULES, create=True):
        return jax_build_model(copy.deepcopy(opt))


def test_sr_model_perceptual_branch_matches_jax(tmp_path):
    """``SRModel`` with ``pixel_opt`` and ``perceptual_opt``: ``l_pix``,
    ``l_percep`` and ``l_style``, and the step."""
    torch.manual_seed(0)
    net = _nonzero_(MSRResNet(num_feat=8, num_block=1), 3)
    torch.save({'params': net.state_dict()}, tmp_path / 'g.pth')
    write_vgg19(tmp_path / 'vgg.pth', convs=3)
    opt = model_opt('SRModel', dict(type='MSRResNet', num_feat=8, num_block=1), tmp_path)
    port, ref = port_build_model(copy.deepcopy(opt)), jax_model(opt, (1, 16, 16, 3))
    before = {k: v.clone() for k, v in port.net_g.state_dict().items()}
    rng = np.random.RandomState(4)
    data = {'lq': torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)),
            'gt': torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32))}
    port.feed_data(data)
    port.optimize_parameters(1)
    ref.feed_data({k: nhwc(v) for k, v in data.items()})
    ref.optimize_parameters(1)
    got, want = port.get_current_log(), ref.get_current_log()
    assert list(got) == list(want) == ['l_pix', 'l_percep', 'l_style']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL), key
    assert got['l_style'] > 1e-2 * got['l_pix'] and got['l_percep'] > 1e-2 * got['l_pix']
    assert_params_close(port.net_g.state_dict(), jax_state_dict(ref.state.params), before, 'G')


def test_sr_model_perceptual_loss_alone(tmp_path):
    """With ``perceptual_opt`` and no ``pixel_opt`` the model trains on the
    perceptual loss alone; with neither it refuses to build."""
    torch.manual_seed(0)
    torch.save({'params': MSRResNet(num_feat=8, num_block=1).state_dict()}, tmp_path / 'g.pth')
    write_vgg19(tmp_path / 'vgg.pth', convs=3)
    opt = model_opt('SRModel', dict(type='MSRResNet', num_feat=8, num_block=1), tmp_path)
    opt['train'].pop('pixel_opt')
    port = port_build_model(copy.deepcopy(opt))
    port.feed_data({'lq': torch.rand(1, 3, 8, 8), 'gt': torch.rand(1, 3, 32, 32)})
    port.optimize_parameters(1)
    assert list(port.get_current_log()) == ['l_percep', 'l_style']
    opt['train'].pop('perceptual_opt')
    with pytest.raises(ValueError):
        port_build_model(copy.deepcopy(opt))


def test_l2s_hm_model_perceptual_branch_matches_jax(tmp_path):
    """``L2SSingleHMModel`` (through ``SwinIRHMModel``) on a network of 3
    bands (VGG reads 3): pixel, perceptual and style terms of both targets,
    weighted, against the JAX model's ``_loss_terms`` on the same batch."""
    sr = dict(img_size=8, patch_size=1, in_chans=3, embed_dim=12, depths=[2], num_heads=[2],
              window_size=4, mlp_ratio=2, upscale=2, img_range=1.0, upsampler='pixelshuffle',
              resi_connection='1conv', drop_path_rate=0.0)
    style = dict(in_chans=3, out_chans=3, num_feat=8)
    network_g = {'type': 'SwinIR_StyleCNN', 'sr_net_args': sr, 'style_net_args': style}
    net = _nonzero_(SwinIR_StyleCNN(sr, style, generator=torch.Generator().manual_seed(0)), 5)
    torch.save({'params': net.state_dict()}, tmp_path / 'g.pth')
    write_vgg19(tmp_path / 'vgg.pth', convs=3)
    opt = model_opt('SwinIRHMModel', network_g, tmp_path, scale=2, hm_loss_weight=0.9,
                    gt_loss_weight=0.1)
    port, ref = port_build_model(copy.deepcopy(opt)), jax_model(opt, (1, 8, 8, 3))
    rng = np.random.RandomState(6)
    lq, gt, hm = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
                  for shape in ((2, 3, 8, 8), (2, 3, 16, 16), (2, 3, 16, 16)))
    port.lq, port.gt, port.hm = lq, gt, hm
    total, losses = port.compute_losses()
    want_total, (want, _, _) = ref._loss_terms(ref.params, {'lq': nhwc(lq), 'gt': nhwc(gt),
                                                            'hm': nhwc(hm)})
    names = [f'{n}_{t}' for t in ('hm', 'gt') for n in ('l_pix', 'l_percep', 'l_style')]
    assert list(losses) == list(want) == names
    for key in names:
        assert losses[key].item() == pytest.approx(float(want[key]), rel=TOL), key
    assert total.item() == pytest.approx(float(want_total), rel=TOL)
