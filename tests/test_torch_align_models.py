"""The port's alignment models (basicsr4rs_torch/models/align_single_model.py,
align_frozen_diff_model.py, align_joint_diff_model.py) against the JAX
package's, on the same L2S batches with the JAX models' own initial weights
(every leaf redrawn non-zero) carried over by ``jax_params_to_state_dict``;
the timesteps and the noise are those the JAX step draws, handed to the
port. Gradients: one SGD step of a large rate in both packages, the JAX
package's gradient read back as (before - after) / rate. Float32 on the CPU
(``num_gpu: 0``, ``use_amp: false``); every number within 1e-5 of the
largest entry of its tensor."""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.models import align_joint_diff_model as port_joint
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils import gaussian_diffusion as port_gd
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.parallel.mesh import replicate

from test_torch_align import AE, LR, TOL, assert_close, nchw, nhwc, redraw

# SGD at this rate makes the update dwarf the weights, so that (before -
# after) / rate keeps the gradient to float32's precision
RATE = 1e6
DIFFUSION = dict(normalize_input=True, schedule_name='exponential', sf=3, min_noise_level=0.2,
                 steps=3, kappa=2.0, etas_end=0.99, schedule_kwargs={'power': 0.3},
                 predict_type='xstart', timestep_respacing=None, latent_flag=False)
# the UNet at test width over the 24x24 latents of GT 24 (LQ 8): one level of
# 64 channels (GroupNorm's 32 groups then hold 2 channels each: at 32 or
# fewer a group of one channel would cancel every per-channel bias before it,
# whose gradients would then be float32 noise), its one Swin layer in the
# middle (Swin 64 in heads of 16, window 4: 36 windows, then shifted)
UNET = dict(image_size=24, in_channels=6, model_channels=64, out_channels=6, num_res_blocks=1,
            attention_resolutions=[], channel_mult=[1], num_head_channels=16,
            swin_embed_dim=64, window_size=4, mlp_ratio=4, cond_lq=True, lq_size=24)


def model_opt(model_type, network_g, train, **top):
    return {'name': 'align', 'model_type': model_type, 'scale': 3, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': copy.deepcopy(network_g),
            'path': {'pretrain_network_g': None, 'pretrain_network_ae': None,
                     'strict_load_g': True},
            'train': {'ema_decay': 0, 'use_amp': False, 'optim_g': {'type': 'SGD', 'lr': RATE},
                      'scheduler': {'type': 'ConstantLR'}, 'total_iter': 10, **train},
            'val': {'val_freq': 10}, **top}


def l2s_batch(seed, b=2, lq=8):
    """An L2S batch as the JAX package takes it (NHWC groups; the GT's NSS on
    half the grid) and as the port does (NCHW)."""
    rng = np.random.RandomState(seed)

    def img(*shape):
        return rng.uniform(-1, 1, (b,) + shape).astype(np.float32)
    jax_batch = {'lq': {'rgb': img(lq, lq, 3), 'nss': img(lq, lq, 3)},
                 'gt': {'rgb': img(3 * lq, 3 * lq, 3), 'nss': img(3 * lq // 2, 3 * lq // 2, 3)},
                 'sample_path': ['a/b/c'] * b, 'img_name': ['a_b_c'] * b}
    port_batch = {k: {g: nchw(a) for g, a in v.items()} if isinstance(v, dict) else v
                  for k, v in jax_batch.items()}
    return jax_batch, port_batch


def build_pair(opt, seed):
    """The JAX model with its parameters redrawn, and the port's model of
    the same options holding them; a first stage likewise."""
    jax_model = jax_build_model(copy.deepcopy(opt))
    params = redraw(jax.device_get(jax_model.state.params), seed)
    jax_model.state = replicate(jax_model.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params)), jax_model.mesh)
    port = port_build_model(copy.deepcopy(opt))
    port.net_g.load_state_dict(jax_params_to_state_dict(
        params, getattr(type(port.net_g), 'JAX_KEY_RULES', None)))
    if getattr(jax_model, 'first_stage', None) is not None:
        stage = redraw(jax.device_get(jax_model.first_stage.params), seed + 1)
        jax_model.first_stage.params = jax.tree_util.tree_map(jnp.asarray, stage)
        port.first_stage.net.load_state_dict(jax_params_to_state_dict(stage))
    return port, jax_model, params


def step_draws(jax_model, latent_shape):
    """The timesteps and noise the JAX diffusion step will draw from the
    model's key, the noise NHWC."""
    _, step_rng = jax.random.split(jax_model.rng)
    k_t, k_noise = jax.random.split(step_rng)
    tt = jax.random.randint(k_t, (latent_shape[0],), 0, jax_model.base_diffusion.num_timesteps)
    return np.array(tt), np.array(jax.random.normal(k_noise, latent_shape, jnp.float32))


def assert_gradients(port, jax_model, params):
    """The port's gradient of every parameter against the JAX step's."""
    after = jax.device_get(jax_model.state.params)
    grads = jax.tree_util.tree_map(lambda a, b: (np.asarray(a, np.float64) - b) / RATE,
                                   params, after)
    want = jax_params_to_state_dict(grads, getattr(type(port.net_g), 'JAX_KEY_RULES', None))
    got = dict(port.net_g.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert_close(got[name].grad.numpy(), g.numpy(), f'gradient of {name}')


def test_align_single_model_step_and_test_match_jax():
    """RegistrationModel: the fed registration input, test()'s stage 2
    cropped to the GT, the two stage losses and every gradient of a step."""
    net = dict(type='StyleResNet', **AE)
    opt = model_opt('RegistrationModel', net, {
        'stage1_opt': {'type': 'MSELoss', 'loss_weight': 0.25},
        'stage2_opt': {'type': 'MSELoss', 'loss_weight': 1.0}})
    port, jax_model, params = build_pair(opt, 0)
    jax_batch, port_batch = l2s_batch(0)
    port.feed_data(port_batch)
    jax_model.feed_data(jax_batch)
    assert port.reg_input.shape == (2, 12, 24, 24)
    assert_close(nhwc(port.reg_input), jax_model.batch['reg_input'], 'reg_input')
    port.test()
    jax_model.test()
    assert port.output.shape == (2, 6, 24, 24)
    assert_close(nhwc(port.output), jax_model.output, 'test() output')
    port.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    got, want = port.get_current_log(), jax_model.get_current_log()
    assert list(got) == list(want) == ['stage1_loss', 'stage2_loss']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL), key
    assert_gradients(port, jax_model, params)


def test_align_joint_diff_model_matches_jax():
    """AlignJointDiffModel with its four losses: test() from the same z_T and
    step noises, then one step's losses and every gradient (the UNet's,
    the align autoencoder's and the LR encoder's)."""
    losses = {key: {'type': 'MSELoss', 'loss_weight': w}
              for key, w in (('decoder_opt', 1.0), ('sr_opt', 0.5), ('diffusion_opt', 0.7))}
    losses['encoder_opt'] = {'type': 'EncoderLoss', 'strategy': 'gt', 'loss_weight': 0.3}
    net = dict(type='ResNetAE_SwinUNet', unet_args=UNET, align_autoencoder_args=AE,
               lr_encoder_args=LR)
    opt = model_opt('AlignJointDiffModel', net, losses, diffusion=copy.deepcopy(DIFFUSION))
    port, jax_model, params = build_pair(opt, 2)
    jax_batch, port_batch = l2s_batch(2)
    port.feed_data(port_batch)
    jax_model.feed_data(jax_batch)

    # test(): the noises the JAX sampler draws (z_T, then one per step)
    _, s_rng = jax.random.split(jax_model.rng)
    k1, k2 = jax.random.split(s_rng)
    shape = (2, 24, 24, 6)
    draws = [jax.random.normal(k1, shape)] + [jax.random.normal(k, shape) for k in
                                              jax.random.split(k2, DIFFUSION['steps'])]
    queue = [nchw(np.array(d)) for d in draws]

    def given(x, generator):
        return queue.pop(0)

    with mock.patch.object(port_joint, '_randn_like', given), \
            mock.patch.object(port_gd, '_randn_like', given):
        port.test()
    assert not queue
    jax_model.test()
    assert port.output.shape == (2, 6, 24, 24)
    assert_close(nhwc(port.output), jax_model.output, 'test() output')

    tt, noise = step_draws(jax_model, shape)
    port.feed_data(dict(port_batch, tt=torch.from_numpy(tt), noise=nchw(noise)))
    port.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    got, want = port.get_current_log(), jax_model.get_current_log()
    assert list(got) == list(want) == ['align', 'diffusion', 'reconstruction', 'sr', 'loss']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL), key
    assert_gradients(port, jax_model, params)
