"""The port's MSRResNet (basicsr4rs_torch/archs/srresnet_arch.py) against the
JAX package's: forward on converted weights, an SGD loss trajectory of the
two packages' SRModel from one ``.pth``, and a ``.pth`` saved by the port
loading in the JAX package. Float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import build_network
from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.archs.srresnet_arch import MSRResNet as JaxMSRResNet
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.utils.torch_convert import load_torch_checkpoint


def _opt(upscale):
    return dict(num_in_ch=3, num_out_ch=3, num_feat=16, num_block=2, upscale=upscale)


@pytest.mark.parametrize('upscale', [2, 3, 4])
def test_forward_matches_jax(upscale):
    """x2, x3 and x4 on the JAX package's parameters, converted: atol 1e-5,
    rtol 1e-5 (float32 convolutions in another order); strict key match."""
    jnet = JaxMSRResNet(**_opt(upscale))
    rng = np.random.RandomState(upscale)
    x = rng.rand(2, 3, 12, 14).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 14, 3)))['params']
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.02 * rng.randn(*v.shape)).astype(np.float32),
        jax.device_get(params))
    want = np.asarray(jnet.apply({'params': params}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    net = build_network(dict(type='MSRResNet', **_opt(upscale))).eval()
    net.load_state_dict(jax_params_to_state_dict(params, MSRResNet.JAX_KEY_RULES), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 12 * upscale, 14 * upscale)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


def test_unsupported_scale_is_refused():
    with pytest.raises(ValueError):
        MSRResNet(upscale=8)


def test_init_is_a_tenth_of_kaiming():
    """Every conv starts at 0.1 x Kaiming-normal with zero bias, as the
    reference's ``default_init_weights(..., 0.1)``."""
    torch.manual_seed(0)
    net = MSRResNet(num_feat=64, num_block=2)
    for name in ('conv_first', 'body.0.conv1', 'upconv1', 'upconv2', 'conv_hr', 'conv_last'):
        conv = net.get_submodule(name)
        fan_in = conv.weight[0].numel()
        assert conv.bias.abs().max() == 0
        assert conv.weight.std().item() == pytest.approx(0.1 * (2 / fan_in)**0.5, rel=0.15)


def test_synthetic_configs_name_the_published_network():
    """The two synthetic configs carry ``network_g`` of the published
    ``train_MSRResNet_x4.yml``."""
    published = yaml_load('options/train/SRResNet_SRGAN/train_MSRResNet_x4.yml')
    for path in ('options/test/SRResNet_SRGAN/test_MSRResNet_x4_synthetic.yml',
                 'options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml'):
        opt = yaml_load(path)
        assert dict(opt['network_g']) == dict(published['network_g'])
        assert opt['num_gpu'] == 'auto' and opt['model_type'] == 'SRModel'
    train = yaml_load('options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml')
    for key in ('gt_size', 'batch_size_per_gpu'):
        assert train['datasets']['train'][key] == published['datasets']['train'][key]
    assert dict(train['train']['optim_g']) == dict(published['train']['optim_g'])


def _model_opt(init_path, tmp_path):
    return {'name': 'trajectory', 'model_type': 'SRModel', 'scale': 4, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(type='MSRResNet', **_opt(4)),
            'path': {'pretrain_network_g': init_path, 'strict_load_g': True,
                     'models': str(tmp_path), 'training_states': str(tmp_path)},
            'train': {'ema_decay': 0.9, 'optim_g': {'type': 'SGD', 'lr': 0.05, 'momentum': 0.9},
                      'scheduler': {'type': 'MultiStepLR', 'milestones': [3], 'gamma': 0.5},
                      'total_iter': 100,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}},
            'val': {'val_freq': 100}}


def test_sgd_trajectory_and_checkpoint_match_jax(tmp_path):
    """5 SGD steps of the two packages' SRModel from one ``.pth`` on the same
    batches: losses rtol 5e-4 / atol 5e-5 (the JAX package's own bound for
    its trajectory against the torch reference), EMA atol 1e-5 + rtol 1e-3;
    then the port's saved ``.pth`` loads in the JAX package and gives the
    port's own evaluation output to 1e-5."""
    torch.manual_seed(1)
    init = MSRResNet(**_opt(4))
    init_path = str(tmp_path / 'init.pth')
    torch.save({'params': init.state_dict()}, init_path)
    port_model = port_build_model(_model_opt(init_path, tmp_path))
    jax_model = jax_build_model(_model_opt(init_path, tmp_path))
    rng = np.random.RandomState(7)
    port_losses, jax_losses = [], []
    for current_iter in range(1, 6):
        lq = rng.rand(2, 3, 12, 12).astype(np.float32)
        gt = rng.rand(2, 3, 48, 48).astype(np.float32)
        port_model.update_learning_rate(current_iter)
        port_model.feed_data({'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt)})
        port_model.optimize_parameters(current_iter)
        port_losses.append(port_model.get_current_log()['l_pix'])
        jax_model.feed_data({'lq': lq.transpose(0, 2, 3, 1), 'gt': gt.transpose(0, 2, 3, 1)})
        jax_model.optimize_parameters(current_iter)
        jax_losses.append(jax_model.get_current_log()['l_pix'])
    np.testing.assert_allclose(port_losses, jax_losses, rtol=5e-4, atol=5e-5)
    assert abs(port_losses[0] - port_losses[-1]) > 1e-4   # it trained

    port_model.save(0, 5)
    saved = str(tmp_path / 'net_g_5.pth')
    ckpt = torch.load(saved, weights_only=True)
    assert sorted(ckpt) == ['params', 'params_ema']
    jax_ema = load_torch_checkpoint(saved, 'params_ema')
    want_ema = jax.tree_util.tree_map(np.asarray, jax.device_get(jax_model.state.ema_params))
    flat_port = jax.tree_util.tree_leaves_with_path(jax_ema)
    flat_jax = dict(jax.tree_util.tree_leaves_with_path(want_ema))
    assert len(flat_port) == len(flat_jax) == 2 * (5 + 2 * 2)   # weight, bias of 9 convs
    for path, value in flat_port:
        np.testing.assert_allclose(np.asarray(value), flat_jax[path], atol=1e-5, rtol=1e-3,
                                   err_msg=str(path))
    # the port's .pth drives the JAX network to the port's own output
    lq = rng.rand(1, 3, 12, 12).astype(np.float32)
    port_model.feed_data({'lq': torch.from_numpy(lq)})
    port_model.test()
    jout = JaxMSRResNet(**_opt(4)).apply({'params': jax_ema},
                                         jnp.asarray(lq.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(port_model.output.numpy(),
                               np.asarray(jout).transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)
