"""Where ``StyleGAN2Model``'s EMA generator starts when it fine-tunes from a
checkpoint (``BaseModel.start_ema``), against the JAX package, on the CPU:
from a ``.pth`` whose ``params`` and ``params_ema`` differ, both packages
start the EMA as a copy of ``params``, and agree after one step
(out_size 16, narrow 0.25; the step replayed from the JAX keys as in
``test_torch_stylegan2.py``).

Tolerances: at the start, equal; after the step, within 1e-3 of each
tensor's change plus 1e-6 of its scale (``test_torch_stylegan2.py``'s).
"""

import copy
from unittest import mock

import jax
import numpy as np
import optax
import torch

from basicsr4rs_torch.archs.stylegan2_arch import StyleGAN2Generator
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import stylegan2_model as jax_stylegan2_model
from basicsr4rs_tpu.parallel import mesh as jax_mesh

from test_torch_ema_start import few_threads, jax_tree_close  # noqa: F401
from test_torch_resshift import _shapes_only
from test_torch_stylegan2 import (ADAM_EPS, MODEL_OPT, REAL, NoiseFromKey, nchw, randomized,
                                  step_draws, with_eps)


def jax_sg2_model(opt):
    """The JAX StyleGAN2Model as ``test_torch_stylegan2.py`` builds it (its
    variables from their shapes, one host device, Adam at ``ADAM_EPS``)."""
    adam = lambda lr, adam=optax.adam, **kw: adam(lr, eps=ADAM_EPS, **kw)  # noqa: E731
    one_device = mock.patch('basicsr4rs_tpu.models.base_model.create_mesh',
                            lambda o: jax_mesh.create_mesh(o, jax.devices()[:1]))
    with mock.patch.object(jax_stylegan2_model, 'jit_init', _shapes_only), one_device, \
            mock.patch.object(jax_stylegan2_model.optax, 'adam', adam):
        return jax_build_model(copy.deepcopy(opt))


def sg2_weights(tmp_path):
    """G's two random sets and D's (the JAX package's variables redrawn as
    ``test_torch_stylegan2.randomized`` does), written as the port saves
    them, less the stored noise maps (not parameters in JAX)."""
    shapes = jax_sg2_model(MODEL_OPT)
    g_rules, d_rules = StyleGAN2Generator.JAX_KEY_RULES, None
    sets = [jax_params_to_state_dict(randomized(jax.device_get(shapes.state.params), seed),
                                     g_rules) for seed in (21, 22)]
    d_sd = jax_params_to_state_dict(randomized(jax.device_get(shapes.d_state.params), 23),
                                    d_rules)
    g_path, d_path = str(tmp_path / 'g.pth'), str(tmp_path / 'd.pth')
    torch.save({'params': sets[0], 'params_ema': sets[1]}, g_path)
    torch.save({'params': d_sd}, d_path)
    return sets, g_path, d_path


def test_stylegan2_ema_starts_from_params_as_jax(tmp_path):
    (params, params_ema), g_path, d_path = sg2_weights(tmp_path)
    opt = copy.deepcopy(MODEL_OPT)
    opt['path'] = {'pretrain_network_g': g_path, 'pretrain_network_d': d_path,
                   'strict_load_g': False, 'strict_load_d': True,
                   'models': str(tmp_path / 'models'),
                   'training_states': str(tmp_path / 'states'),
                   'visualization': str(tmp_path / 'vis')}
    ref = jax_sg2_model(opt)
    ref.net_g = NoiseFromKey(ref.net_g)
    from basicsr4rs_torch.models import stylegan2_model as port_module
    with mock.patch.object(port_module.StyleGAN2Model, 'get_optimizer',
                           with_eps(port_module.StyleGAN2Model.get_optimizer)):
        port = port_build_model(dict(copy.deepcopy(opt), num_gpu=0))
    rules = StyleGAN2Generator.JAX_KEY_RULES
    for key, value in params.items():
        assert torch.equal(port.net_g_ema.state_dict()[key], value), key
    assert any(not torch.equal(params[k], params_ema[k]) for k in params)
    jax_tree_close(port.net_g_ema, ref.state.ema_params, rules)

    start = {k: v.clone() for k, v in port.net_g_ema.state_dict().items()}
    rng_before = ref.rng
    ref.feed_data({'gt': REAL})
    ref.optimize_parameters(1)
    draws = step_draws(ref, jax.random.split(rng_before)[1], 2, 16)
    port.feed_data({'gt': nchw(REAL)})
    with mock.patch.object(port, 'draw_step', lambda batch, regularize_g: draws):
        port.optimize_parameters(1)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref.state.ema_params),
                                    rules)
    moved = 0
    for key, value in want.items():
        got, begin = port.net_g_ema.state_dict()[key].double(), start[key].double()
        change = (value.double() - begin).abs().max().item()
        err = (got - value.double()).abs().max().item()
        moved += change > 0
        assert err <= 1e-3 * change + 1e-6 * value.abs().max().item(), f'{key}: {err:.3e}'
    # one step at (1 - decay) = 0.0022 moves the EMA of the style MLP (weights of
    # about 100, learning at 0.01 of the rate) by less than its float32 rounding
    assert moved > 0.8 * len(want), (moved, len(want))
