"""The port's SwinIR (basicsr4rs_torch/archs/swinir_arch.py) against the JAX
package's, on one set of random weights: the JAX parameters, as numpy,
become the port's state_dict through ``jax_params_to_state_dict``. Float32
on the CPU, where every Swin block runs the plain PyTorch version."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import swinir_arch as port_arch
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_arch
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

UPSAMPLERS = [('pixelshuffle', 2), ('pixelshuffle', 4), ('pixelshuffledirect', 2),
              ('nearest+conv', 4), ('', 1)]


def _config(upsampler, upscale):
    return dict(img_size=24, patch_size=1, in_chans=3, embed_dim=18, depths=(2, 2),
                num_heads=(3, 3), window_size=8, mlp_ratio=2., upscale=upscale, img_range=1.,
                upsampler=upsampler, resi_connection='1conv')


def _randomize(tree, rng):
    """Every leaf random: kernels N(0, 1/fan_in), LayerNorm scales near 1,
    biases and bias tables small, so every parameter shows in the output."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize(value, rng)
            continue
        shape = np.shape(value)
        if key == 'kernel':
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == 'scale':
            arr = 1 + 0.1 * rng.randn(*shape)
        elif key == 'relative_position_bias_table':
            arr = 0.5 * rng.randn(*shape)
        else:
            arr = 0.05 * rng.randn(*shape)
        out[key] = arr.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_net_and_params(upsampler, upscale):
    net = jax_arch.SwinIR(**_config(upsampler, upscale))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 24, 3), jnp.float32))['params']
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return net, _randomize(params, np.random.RandomState(len(upsampler) + upscale))


def _port_net(upsampler, upscale, params):
    net = port_arch.SwinIR(**_config(upsampler, upscale)).eval()
    net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES),
                        strict=True)
    return net


@pytest.mark.parametrize('size', [24, 8], ids=['24px_shifted', '8px_one_window'])
@pytest.mark.parametrize('upsampler, upscale', UPSAMPLERS)
def test_swinir_matches_jax(upsampler, upscale, size):
    """Forward parity at 24x24 (3x3 windows, shifted blocks masked) and at
    8x8 (one window, no shift by the small-input rule); atol 1e-4, rtol 1e-4
    for float32 sums taken in another order through 4 Swin blocks."""
    jnet, params = _jax_net_and_params(upsampler, upscale)
    x = np.random.RandomState(size).rand(1, 3, size, size).astype(np.float32)
    want = np.asarray(jnet.apply({'params': params}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = _port_net(upsampler, upscale, params)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 3, size * upscale, size * upscale)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize('upsampler, upscale', UPSAMPLERS)
def test_state_dict_round_trip(upsampler, upscale):
    """convert_torch_state_dict(jax_params_to_state_dict(p)) == p, and the
    state_dict loads strictly into the port's SwinIR, so one random torch
    state_dict feeds both packages."""
    jnet, params = _jax_net_and_params(upsampler, upscale)
    state_dict = jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES)
    port_keys = set(port_arch.SwinIR(**_config(upsampler, upscale)).state_dict())
    assert set(state_dict) == port_keys
    back = dict(_flatten(convert_torch_state_dict(state_dict, rules=jnet.torch_key_rules)))
    want = dict(_flatten(params))
    assert back.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg='.'.join(key))


def test_window_index_and_shift_mask_match_jax():
    cpu = torch.device('cpu')
    np.testing.assert_array_equal(port_arch._relative_position_index(8, 8, cpu).numpy(),
                                  jax_arch._relative_position_index(8, 8).reshape(-1))
    for h, w in [(24, 24), (16, 40)]:
        np.testing.assert_array_equal(port_arch._shift_attn_mask(h, w, 8, 4, cpu).numpy(),
                                      jax_arch._shift_attn_mask(h, w, 8, 4))


def test_seeded_init_is_reproducible():
    """Parameter init draws from the generator it is given."""
    cfg = _config('pixelshuffle', 2)
    a = port_arch.SwinIR(**cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    b = port_arch.SwinIR(**cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    assert a.keys() == b.keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    table = a['layers.0.residual_group.blocks.0.attn.relative_position_bias_table']
    assert 0 < table.abs().max() <= 0.04   # trunc-normal, std .02, cut at 2 std


# widths past the joint kernels' (C <= 192, heads of at most 32 features):
# SwinIR-L's 240 in 8 heads of 30, and 3 heads of 60; and one the joint takes
WIDE = [pytest.param(240, 8, id='C240-8heads'), pytest.param(180, 3, id='C180-3heads-of-60')]


def _wide_config(embed, heads):
    return dict(img_size=16, patch_size=1, in_chans=3, embed_dim=embed, depths=(2,),
                num_heads=(heads,), window_size=8, mlp_ratio=2., upscale=1, img_range=1.,
                upsampler='', resi_connection='1conv')


@pytest.mark.parametrize('embed, heads', WIDE)
def test_eval_past_the_joint_widths_matches_jax(embed, heads):
    """The eval forward of a SwinIR wider than the joint kernel takes (its
    blocks on the split pair's plain versions here, K2 + K4 on a card)
    against JAX SwinIR: LQ 16x16, two blocks, the second shifted; atol and
    rtol 1e-4."""
    cfg = _wide_config(embed, heads)
    jnet = jax_arch.SwinIR(**cfg)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(embed + heads))
    x = np.random.RandomState(3).rand(1, 3, 16, 16).astype(np.float32)
    want = np.asarray(jnet.apply({'params': params}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    net = port_arch.SwinIR(**cfg).eval()
    net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('embed, heads, joint', [(240, 8, False), (180, 3, False), (96, 3, True)],
                         ids=['C240-8heads', 'C180-heads-of-60', 'C96-heads-of-32'])
def test_eval_route_is_chosen_by_the_width(embed, heads, joint):
    """In eval a block runs the joint block where the joint kernel takes its
    width, else the split pair (attention branch, then MLP branch, each with
    its residual); the shape decides, before any launch."""
    net = port_arch.SwinIR(**_wide_config(embed, heads)).eval()
    names = ('fused_swin_block_full', 'fused_swin_attn_block', 'fused_mlp_block')
    spies = {name: mock.patch.object(port_arch, name, wraps=getattr(port_arch, name))
             for name in names}
    calls = {}
    with spies[names[0]] as full, spies[names[1]] as attn, spies[names[2]] as mlp:
        with torch.no_grad():
            net(torch.rand(1, 3, 16, 16))
        calls = {'full': full.call_count, 'attn': attn.call_count, 'mlp': mlp.call_count}
    blocks = 2
    assert calls == ({'full': blocks, 'attn': 0, 'mlp': 0} if joint else
                     {'full': 0, 'attn': blocks, 'mlp': blocks})
    for call in attn.call_args_list + mlp.call_args_list:
        assert call.kwargs == {'add_residual': True}


def test_int8_route_keeps_refusing_past_the_joint_widths():
    """Under ``swin_kernels=True`` every block stays on the W8A8 joint block,
    also past the float joint kernel's widths. Its own gate takes SwinIR-L's
    C = 240 in heads of 30 and C = 180 in heads of 60: their launch passes
    every check and fails only for want of a card. Past its limit (C <= 256,
    heads of at most 64 features) it refuses, with that limit, before
    anything is built."""
    from basicsr4rs_torch.ops import swin_block as S
    for embed, heads, takes in ((240, 8, True), (180, 3, True), (272, 8, False)):
        assert S.int8_block_takes(embed, heads) == takes
        assert not S.joint_block_takes(embed, heads)
        net = port_arch.SwinIR(**_wide_config(embed, heads)).eval()
        with mock.patch.object(port_arch, 'swin_kernels_int8', return_value=True), \
                mock.patch.object(port_arch, 'swin_block_full_int8',
                                  wraps=port_arch.swin_block_full_int8) as int8, \
                mock.patch.object(port_arch, 'fused_swin_attn_block') as attn:
            with torch.no_grad():
                net(torch.rand(1, 3, 16, 16))
        assert int8.call_count == 2 and attn.call_count == 0
        x, *block = int8.call_args.args[:15]
        error, match = ((RuntimeError, 'nvcc|CUDA') if takes else
                        (ValueError, 'takes C <= 256 and a head dim <= 64'))
        with pytest.raises(error, match=match):
            S._launch_joint_int8(x, *block, 8, heads, (embed // heads)**-.5)
