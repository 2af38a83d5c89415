"""The port's SR3 (basicsr4rs_torch/archs/sr3_arch.py) against the JAX
package's: the seven beta schedules and ``SR3.make_schedule``'s tables
exactly (the same float64 numpy), the noise-level encoding, the FiLM
residual block with and without ``use_affine_level``, and ``SR3UNet``'s
forward and every parameter's gradient, float32 on the CPU on one set of
random weights carried across by ``utils.jax_convert``. Networks and
gradients within 1e-4 of the largest entry of each tensor (float32 sums in
another order through the whole network, ``F32_TOL`` of the Swin and UNet
tests); the block within 1e-5 absolute."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import sr3_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.registry import ARCH_REGISTRY
from basicsr4rs_tpu.archs import sr3_arch as ref
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_swinir import _flatten, _randomize
from test_torch_unet import assert_close_rel, jax_params, nchw, nhwc

RULES = port.SR3UNet.JAX_KEY_RULES
SCHEDULES = ['quad', 'linear', 'warmup10', 'warmup50', 'const', 'jsd', 'cosine']
# two levels with attention at 8 (the second), three with attention at 4: the
# down path, the middle, the up path with its skips, and res_conv at every
# change of width
UNETS = {
    'attn-at-8': dict(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
                      channel_mults=(1, 2), attn_res=(8,), res_blocks=1, image_size=16),
    'three-levels': dict(in_channel=4, out_channel=2, inner_channel=8, norm_groups=32,
                         channel_mults=(1, 2, 2), attn_res=(4,), res_blocks=2, image_size=16),
}


@pytest.mark.parametrize('schedule', SCHEDULES)
def test_beta_schedules(schedule):
    for n, start, end in ((10, 1e-4, 2e-2), (37, 1e-6, 1e-2)):
        want = ref.make_beta_schedule(schedule, n, start, end)
        got = port.make_beta_schedule(schedule, n, start, end)
        assert got.dtype == np.float64 and got.shape == (n,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        port.make_beta_schedule('sigmoid', 10)


@pytest.mark.parametrize('schedule', ['linear', 'cosine', 'warmup10'])
def test_make_schedule_tables(schedule):
    """All twelve tables, the same numbers in float64."""
    unet_opt = dict(UNETS['attn-at-8'])
    opt = dict(schedule=schedule, n_timestep=20, linear_start=1e-6, linear_end=1e-2)
    want = ref.SR3(unet_opt=unet_opt, schedule_opt=opt).make_schedule()
    got = port.SR3(unet_opt=unet_opt, schedule_opt=opt).make_schedule()
    assert len(got) == 12 and got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_positional_encoding():
    level = np.array([0.01, 0.3, 0.97], np.float32)
    want = np.asarray(ref.positional_encoding(jnp.asarray(level), 16))
    got = port.positional_encoding(torch.from_numpy(level), 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize('affine, attn, width', [(False, False, 16), (True, False, 8),
                                                 (True, True, 16)],
                         ids=['shift', 'film-res-conv', 'film-attention'])
def test_resnet_block(affine, attn, width):
    """The FiLM-conditioned residual block: ``use_affine_level``, the
    whole-map attention, ``res_conv`` where the widths differ (8 -> 16)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, width, 8, 8).astype(np.float32)
    emb = rng.randn(2, 12).astype(np.float32)
    jmod = ref._ResnetBlockAttn(width, 16, 12, norm_groups=4, with_attn=attn,
                                use_affine_level=affine)
    params = jax_params(jmod, 4, nhwc(x), jnp.asarray(emb))
    want = nchw(jmod.apply({'params': params}, nhwc(x), jnp.asarray(emb)))
    net = port.ResnetBlocWithAttn(width, 16, noise_level_emb_dim=12, norm_groups=4,
                                  with_attn=attn, use_affine_level=affine)
    # the block's keys as they stand in a network, less the network's prefix
    carried = jax_params_to_state_dict({'downs_1': params}, RULES)
    net.load_state_dict({k[len('downs.1.'):]: v for k, v in carried.items()})
    got = net(torch.from_numpy(x), torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_unet(name):
    """The JAX network and its parameters, every leaf random: shapes from
    ``jax.eval_shape`` (no init), one draw a configuration."""
    cfg = UNETS[name]
    jnet = ref.SR3UNet(**cfg)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, cfg['in_channel'])), jnp.zeros((1,))))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes['params'])
    return jnet, _randomize(zeros, np.random.RandomState(5))


def _unet(name, seed=0):
    cfg = UNETS[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(2, cfg['in_channel'], 16, 16).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    jnet, params = _jax_unet(name)
    net = port.SR3UNet(**cfg)
    net.load_state_dict(jax_params_to_state_dict(params, RULES))
    return jnet, params, net, x, t


@pytest.mark.parametrize('name', list(UNETS))
def test_sr3_unet_forward(name):
    jnet, params, net, x, t = _unet(name)
    want = nchw(jax.jit(lambda p: jnet.apply({'params': p}, nhwc(x), jnp.asarray(t)))(params))
    got = net.eval()(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert got.shape == (2, UNETS[name]['out_channel'], 16, 16)
    assert_close_rel(got, want, 1e-4)


@pytest.mark.parametrize('name', list(UNETS))
def test_sr3_unet_gradients(name):
    """Every parameter's gradient of a mean-square loss, 1e-4 of each
    tensor's largest entry; a tensor whose gradient is float32 noise (a
    bias that a GroupNorm cancels) is held to 1e-3 of the largest of all."""
    jnet, params, net, x, t = _unet(name, seed=1)
    target = np.random.RandomState(9).randn(2, UNETS[name]['out_channel'], 16, 16)
    target = target.astype(np.float32)

    def jax_loss(p):
        return jnp.mean((jnet.apply({'params': p}, nhwc(x), jnp.asarray(t)) - nhwc(target))**2)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, jax.device_get(want)),
                                    RULES)
    loss = ((net.train()(torch.from_numpy(x), torch.from_numpy(t))
             - torch.from_numpy(target))**2).mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for key, grad in got.items():
        assert_close_rel(grad.numpy(), want[key].numpy(), 1e-4, key, floor)


@pytest.mark.parametrize('name', list(UNETS))
def test_state_dict_round_trip(name):
    """BasicSR's keys: the port's state_dict, through the JAX package's
    ``TORCH_KEY_RULES``, is the JAX tree leaf for leaf, and the JAX tree
    through ``JAX_KEY_RULES`` loads strictly into the port."""
    _, params, net, _, _ = _unet(name)
    state_dict = jax_params_to_state_dict(params, RULES)
    assert set(state_dict) == set(net.state_dict())
    for key in ('downs.1.res_block.block1.block.0.weight',
                'downs.1.res_block.noise_func.noise_func.0.weight',
                'mid.0.attn.qkv.weight', 'downs.0.weight', 'noise_level_mlp.3.bias',
                'final_conv.block.3.weight'):
        assert key in state_dict, key
    back = dict(_flatten(convert_torch_state_dict(state_dict, rules=ref.SR3UNet.TORCH_KEY_RULES)))
    want = dict(_flatten(params))
    assert back.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg='.'.join(key))


def test_sr3_wraps_the_unet_and_both_are_registered():
    assert ARCH_REGISTRY.get('SR3UNet') is port.SR3UNet
    assert ARCH_REGISTRY.get('SR3') is port.SR3
    cfg = UNETS['attn-at-8']
    _, params, unet, x, t = _unet('attn-at-8')
    sr3 = port.SR3(unet_opt=cfg, schedule_opt=dict(schedule='linear', n_timestep=4))
    sr3.load_state_dict(jax_params_to_state_dict({'unet': params}, port.SR3.JAX_KEY_RULES))
    with torch.no_grad():
        torch.testing.assert_close(sr3(torch.from_numpy(x), torch.from_numpy(t)),
                                   unet(torch.from_numpy(x), torch.from_numpy(t)),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match='with_noise_level_emb'):
        port.SR3UNet(**cfg, with_noise_level_emb=False)
