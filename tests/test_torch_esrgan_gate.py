"""The gate of the port's ``SRGANModel`` (basicsr4rs_torch/models/
srgan_model.py) against the JAX package's: with ``net_d_init_iters`` the
generator's first steps leave it and its Adam state as they are while the
schedule goes on; and the two networks' checkpoints and training state.
Float32 on the CPU; the setup of tests/test_torch_esrgan.py."""

import copy

import numpy as np
import pytest
import torch

from basicsr4rs_torch.models import build_model as port_build_model

from test_torch_esrgan import (TOL, assert_params_close, batch, gan_opt, jax_model, jax_state_dict,
                               nhwc, write_inputs)


def test_gated_generator_step_matches_jax(tmp_path):
    """``net_d_init_iters: 1`` with Adam: step 1 leaves G, its Adam moments
    and its step count as they are while D trains; the schedule (a milestone
    after step 1) goes on, so step 2 is Adam's first at half the rate. After
    step 2, G agrees with the JAX package's. Adam's ``eps`` is set near the
    gradients' size, so that an update is a smooth function of its gradient
    (at 1e-8 it is the rate times the gradient's sign, which float32 noise
    flips where a gradient is near 0) and tells a first Adam step from a
    second."""
    write_inputs(tmp_path)
    opt = gan_opt('SRGANModel', tmp_path, {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99],
                                                'eps': 1e-2},
                  net_d_init_iters=1, perceptual_opt=None,
                  scheduler={'type': 'MultiStepLR', 'milestones': [1], 'gamma': 0.5})
    port = port_build_model(copy.deepcopy(opt))
    ref = jax_model(opt)
    g_before = {k: v.clone() for k, v in port.net_g.state_dict().items()}
    d_before = {k: v.clone() for k, v in port.net_d.state_dict().items()}
    data = batch(3)
    port.feed_data(data)
    ref.feed_data({k: nhwc(v) for k, v in data.items()})
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    ref.optimize_parameters(1)
    for key, value in port.net_g.state_dict().items():
        assert torch.equal(value, g_before[key]), key
    assert not port.optimizer_g.state   # no moments, no step count
    assert any(not torch.equal(v, d_before[k]) for k, v in port.net_d.state_dict().items())
    assert np.array_equal(np.asarray(ref.state.params['conv_first']['kernel']),
                          g_before['conv_first.weight'].numpy().transpose(2, 3, 1, 0))

    port.update_learning_rate(2)
    assert port.get_current_learning_rate() == [5e-4]
    port.optimize_parameters(2)
    ref.optimize_parameters(2)
    states = list(port.optimizer_g.state.values())
    assert states and all(s['step'].item() == 1 for s in states)
    assert_params_close(port.net_g.state_dict(), jax_state_dict(ref.state.params), g_before, 'G')
    got, want = port.get_current_log(), ref.get_current_log()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL, abs=1e-7), key


def test_save_and_resume_keep_both_networks_and_the_batch_statistics(tmp_path):
    """``save`` writes G (``params``, ``params_ema``) and D; the ``.state``
    holds both optimizers and the D's running statistics, which
    ``resume_training`` puts back."""
    write_inputs(tmp_path)
    opt = gan_opt('ESRGANModel', tmp_path, {'type': 'Adam', 'lr': 1e-4})
    port = port_build_model(copy.deepcopy(opt))
    port.feed_data(batch())
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    port.save(0, 1)
    assert sorted(torch.load(tmp_path / 'models' / 'net_g_1.pth', weights_only=True)) == [
        'params', 'params_ema']
    d_saved = torch.load(tmp_path / 'models' / 'net_d_1.pth', weights_only=True)['params']
    assert torch.equal(d_saved['bn0_1.running_var'], port.net_d.bn0_1.running_var.cpu())
    state = torch.load(tmp_path / 'states' / '1.state', weights_only=True)
    assert len(state['optimizers']) == 2 and 'bn3_1.running_mean' in state['stats_d']

    fresh = port_build_model(copy.deepcopy(opt))
    fresh.resume_training(state)
    for key, value in port.net_d.state_dict().items():
        if 'running' in key:
            assert torch.equal(fresh.net_d.get_buffer(key), value), key
    assert fresh.optimizer_d.state_dict()['state'].keys() == \
        port.optimizer_d.state_dict()['state'].keys()
