"""Where the EMA network starts when a model fine-tunes from a checkpoint
(``BaseModel.start_ema``), against the JAX package, on the CPU: from a
``.pth`` whose ``params`` and ``params_ema`` differ, both packages start
the EMA as a copy of ``params`` (the weights loaded under ``param_key_g``),
and agree after one step: ``SRModel`` (MSRResNet x4, 16 features, 2
blocks; SGD, EMA 0.9) here, ``StyleGAN2Model`` in
``test_torch_ema_start_stylegan2.py``. A resumed run reads ``params_ema``
instead, where the JAX package restores its EMA with the training state.

Tolerances: at the start, equal; after a step, within 1e-5 + 1e-3 relative
(``test_torch_srresnet.py``'s).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.models import build_model as jax_build_model

from test_torch_srresnet import _model_opt, _opt


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def two_sets(net_cls, kwargs, path):
    """A ``.pth`` of two different random sets, ``params`` and
    ``params_ema``; returns them."""
    torch.manual_seed(1)
    params = net_cls(**kwargs).state_dict()
    torch.manual_seed(2)
    params_ema = net_cls(**kwargs).state_dict()
    torch.save({'params': params, 'params_ema': params_ema}, path)
    return params, params_ema


def assert_state_equal(net, state_dict):
    for key, value in net.state_dict().items():
        assert torch.equal(value, state_dict[key]), key


def jax_tree_close(port_net, tree, rules=None, atol=0., rtol=0.):
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), rules)
    assert want
    for key, value in want.items():
        np.testing.assert_allclose(port_net.state_dict()[key].numpy(), value.numpy(),
                                   atol=atol, rtol=rtol, err_msg=key)


def test_srmodel_ema_starts_from_params_as_jax(tmp_path):
    path = str(tmp_path / 'init.pth')
    params, params_ema = two_sets(MSRResNet, _opt(4), path)
    opt = _model_opt(path, tmp_path)
    port, ref = port_build_model(copy.deepcopy(opt)), jax_build_model(copy.deepcopy(opt))
    assert_state_equal(port.net_g_ema, params)
    assert not torch.equal(params['conv_first.weight'], params_ema['conv_first.weight'])
    jax_tree_close(port.net_g_ema, ref.state.ema_params)

    rng = np.random.RandomState(7)
    lq = rng.rand(2, 3, 12, 12).astype(np.float32)
    gt = rng.rand(2, 3, 48, 48).astype(np.float32)
    port.update_learning_rate(1)
    port.feed_data({'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt)})
    port.optimize_parameters(1)
    ref.feed_data({'lq': lq.transpose(0, 2, 3, 1), 'gt': gt.transpose(0, 2, 3, 1)})
    ref.optimize_parameters(1)
    jax_tree_close(port.net_g_ema, ref.state.ema_params, atol=1e-5, rtol=1e-3)


def test_resumed_srmodel_reads_params_ema(tmp_path):
    path = str(tmp_path / 'net_g_4.pth')
    _, params_ema = two_sets(MSRResNet, _opt(4), path)
    opt = _model_opt(path, tmp_path)
    opt['path']['resume_state'] = str(tmp_path / '4.state')   # as check_resume leaves it
    assert_state_equal(port_build_model(opt).net_g_ema, params_ema)
