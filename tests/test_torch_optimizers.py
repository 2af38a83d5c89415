"""The port's Adafactor and Lamb (basicsr4rs_torch/models/optimizers.py,
built by ``BaseModel.get_optimizer`` and stepped by the port's scheduler)
against the JAX package's ``build_optimizer`` (``optax.adafactor`` and
``optax.lamb``) under the same ``MultiStepLR`` schedule, on the CPU.

The parameters: a 3x3 convolution of 128 -> 160 channels (OIHW here, HWIO
in JAX: factored over its two channel dimensions), a linear of 192 -> 128
((out, in) against (in, out): factored), an (8, 300) matrix (unfactored: its
second dimension is under 128) and a bias that starts at zero (Lamb's trust
ratio is 1 there, Adafactor's parameter scale its floor). Gradients: one
seeded numpy draw a step. Tolerance: each parameter within 1e-5 of its
largest entry after every one of five steps (float32, another order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from basicsr4rs_torch.models import optimizers
from basicsr4rs_torch.models.base_model import BaseModel
from basicsr4rs_tpu.models.base_model import build_optimizer
from basicsr4rs_tpu.models.lr_scheduler import build_schedule

SCHEDULER = {'type': 'MultiStepLR', 'milestones': [2, 4], 'gamma': 0.5}
STEPS = 5
PARAM_TOL = 1e-5
# torch layout -> JAX layout
TO_JAX = {'conv': (2, 3, 1, 0), 'linear': (1, 0), 'matrix': (0, 1), 'bias': (0,)}
SHAPES = {'conv': (160, 128, 3, 3), 'linear': (128, 192), 'matrix': (8, 300), 'bias': (160,)}
CONFIGS = {
    'Adafactor': {'type': 'Adafactor', 'lr': 1e-2},
    'Lamb': {'type': 'Lamb', 'lr': 1e-2, 'betas': [0.9, 0.99], 'eps': 1e-8,
             'weight_decay': 1e-2},
}


def initial_params(rng):
    params = {name: (rng.standard_normal(shape) * 0.05).astype(np.float32)
              for name, shape in SHAPES.items()}
    params['bias'][:] = 0.
    return params


def port_model(optim_opt, params):
    """A bare ``BaseModel`` holding one optimizer of ``optim_opt`` over
    ``params`` (torch tensors) and the configured scheduler."""
    model = BaseModel({'is_train': True, 'num_gpu': 0, 'train': {'scheduler': dict(SCHEDULER)}})
    opt = dict(optim_opt)
    model.optimizers.append(model.get_optimizer(opt.pop('type'), list(params.values()),
                                                **opt))
    model.setup_schedulers()
    return model


@pytest.mark.parametrize('name', list(CONFIGS))
def test_five_steps_match_optax(name):
    rng = np.random.default_rng(0)
    start = initial_params(rng)
    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in start.items()}
    model = port_model(CONFIGS[name], params)
    assert type(model.optimizers[0]).__name__ == name

    tx = build_optimizer(CONFIGS[name], build_schedule(CONFIGS[name]['lr'], SCHEDULER))
    jparams = {k: jnp.asarray(v.transpose(TO_JAX[k])) for k, v in start.items()}
    state = tx.init(jparams)
    rates = []
    for it in range(1, STEPS + 1):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
        model.update_learning_rate(it)
        rates.append(model.get_current_learning_rate()[0])
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        model.optimizers[0].step()
        updates, state = tx.update({k: jnp.asarray(g.transpose(TO_JAX[k]))
                                    for k, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            want = np.asarray(jparams[k]).transpose(np.argsort(TO_JAX[k]))
            got = p.detach().numpy()
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=PARAM_TOL * scale, rtol=0,
                                       err_msg=f'{name} step {it}: {k}')
            assert not np.allclose(got, start[k])   # every tensor moved
    assert rates == [1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3]   # the scheduler drove the rate


def test_adafactor_factors_the_two_largest_dimensions():
    assert optimizers.factored_dims((160, 128, 3, 3), 128) == (1, 0)
    assert optimizers.factored_dims((3, 3, 128, 160), 128) == (2, 3)
    assert optimizers.factored_dims((8, 300), 128) is None
    assert optimizers.factored_dims((160,), 128) is None
    p = torch.zeros(160, 128, 3, 3, requires_grad=True)
    p.grad = torch.ones_like(p)
    opt = optimizers.Adafactor([p], 1.)
    opt.step()
    state = opt.state[p]
    assert state['v_row'].shape == (128, 3, 3) and state['v_col'].shape == (160, 3, 3)


def test_adafactor_does_not_depend_on_the_layout():
    """The same 128 -> 160 convolution and gradients as OIHW and as HWIO:
    the same updates, three steps."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((160, 128, 3, 3)) * 0.05).astype(np.float32)
    oihw = torch.from_numpy(w.copy()).requires_grad_()
    hwio = torch.from_numpy(w.transpose(2, 3, 1, 0).copy()).requires_grad_()
    opts = optimizers.Adafactor([oihw], 1e-2), optimizers.Adafactor([hwio], 1e-2)
    for _ in range(3):
        g = rng.standard_normal(w.shape).astype(np.float32)
        oihw.grad, hwio.grad = torch.from_numpy(g), torch.from_numpy(g.transpose(2, 3, 1, 0))
        for opt in opts:
            opt.step()
        np.testing.assert_allclose(hwio.detach().numpy(),
                                   oihw.detach().numpy().transpose(2, 3, 1, 0),
                                   atol=PARAM_TOL * np.abs(w).max(), rtol=0)


def test_other_optimizers_are_refused():
    model = BaseModel({'is_train': True, 'num_gpu': 0})
    with pytest.raises(NotImplementedError):
        model.get_optimizer('Adagrad', [torch.zeros(1, requires_grad=True)], 1e-3)
