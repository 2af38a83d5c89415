"""SwinIR's options past the main path's (basicsr4rs_torch/archs/swinir_arch.py):
``resi_connection: 3conv``, ``ape`` with ``patch_size`` 1 and 2,
``fused_attn: false`` (the model's unfused chain), ``qkv_bias: false``, and
``drop_rate`` / ``attn_drop_rate`` above 0. Forwards against the JAX
package's SwinIR on one set of random weights (shapes from ``jax.eval_shape``
at the input size, every leaf random, carried across by
``utils.jax_convert``), float32 on the CPU, where every kernel wrapper runs
its plain version: atol 1e-4 + rtol 1e-4 (``F32_TOL`` of
``tests/test_torch_swinir.py``); gradients of 3conv and the unfused route
through ``jax.jit``, atol 2e-5 + rtol 2e-3 as in
``tests/test_torch_swinir_train.py``. Training with rates above 0 cannot
share masks with the JAX package, whose random streams differ: the dropped
share and the 1 / keep scale, the seeded generator, its ``.state`` round
trip and the route each rate selects are held instead."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import swinir_arch as port_arch
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.ops import mlp_block as port_mlp
from basicsr4rs_torch.ops import swin_block as port_swin
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_arch
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_swinir import _flatten, _randomize
from test_torch_swinir_train import grads_to_state_dict

SIZE = 16
RULES = port_arch.SwinIR.JAX_KEY_RULES


def _config(**kw):
    """2 RSTBs of 2 blocks at window 4 on a 16x16 map: the second block of
    each shifted by 2 under the mask."""
    cfg = dict(img_size=SIZE, patch_size=1, in_chans=3, embed_dim=24, depths=(2, 2),
               num_heads=(2, 2), window_size=4, mlp_ratio=2., upscale=2, img_range=1.,
               upsampler='pixelshuffle', resi_connection='1conv', drop_path_rate=0.)
    cfg.update(kw)
    return cfg


VARIANTS = {
    '3conv': _config(resi_connection='3conv'),
    'ape': _config(ape=True),
    'ape-patch2': _config(ape=True, patch_size=2, img_size=2 * SIZE),
    'unfused': _config(fused_attn=False),
    'unfused-3conv-ape': _config(fused_attn=False, resi_connection='3conv', ape=True),
    'no-qkv-bias': _config(qkv_bias=False),
    'no-qkv-bias-unfused': _config(qkv_bias=False, fused_attn=False),
    'eval-with-rates': _config(drop_rate=0.2, attn_drop_rate=0.1, drop_path_rate=0.3),
    'eval-with-proj-drop': _config(drop_rate=0.2, upsampler='nearest+conv', upscale=4),
}


@functools.lru_cache(maxsize=None)
def _jax_net(name):
    """The JAX SwinIR of a variant and its parameters, every leaf random;
    shapes from ``jax.eval_shape`` on the 16x16 input, which sets the JAX
    ``absolute_pos_embed``'s token count (the port's is BasicSR's,
    (img_size // patch_size)**2: the same here)."""
    jnet = jax_arch.SwinIR(**VARIANTS[name])
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, SIZE, SIZE, 3))))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes['params'])
    return jnet, _randomize(zeros, np.random.RandomState(len(name)))


def _port_net(name, params):
    net = port_arch.SwinIR(**VARIANTS[name])
    net.load_state_dict(jax_params_to_state_dict(params, RULES), strict=True)
    return net


@pytest.mark.parametrize('name', list(VARIANTS))
def test_forward_matches_jax(name):
    """Eval forward; with rates above 0 the port keeps its kernel routes
    (dropout is the identity in eval), the JAX block its XLA chain."""
    jnet, params = _jax_net(name)
    x = np.random.RandomState(1).rand(2, 3, SIZE, SIZE).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jnet.apply({'params': p}, jnp.asarray(
        x.transpose(0, 2, 3, 1))))(params)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = _port_net(name, params).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('name', ['3conv', 'unfused', 'unfused-3conv-ape'])
def test_gradients_match_jax(name):
    """Loss and every parameter's gradient of an L1 loss in train(), no
    DropPath, against ``jax.value_and_grad`` of the JAX network."""
    jnet, params = _jax_net(name)
    rng = np.random.RandomState(2)
    lq = rng.rand(2, 3, SIZE, SIZE).astype(np.float32)
    gt = rng.rand(2, 3, 2 * SIZE, 2 * SIZE).astype(np.float32)

    def jax_loss(p):
        out = jnet.apply({'params': p}, jnp.asarray(lq.transpose(0, 2, 3, 1)),
                         deterministic=False, rngs={'dropout': jax.random.PRNGKey(0)})
        return jnp.abs(out - jnp.asarray(gt.transpose(0, 2, 3, 1))).mean()

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = grads_to_state_dict(want)
    net = _port_net(name, params).train()
    loss = (net(torch.from_numpy(lq)) - torch.from_numpy(gt)).abs().mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    for key, grad in got.items():
        assert grad.abs().max() > 0, key
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(), atol=2e-5, rtol=2e-3,
                                   err_msg=key)


@pytest.mark.parametrize('name', ['3conv', 'ape', 'unfused-3conv-ape'])
def test_state_dict_round_trip(name):
    """BasicSR's keys (``layers.i.conv.0/.2/.4``, ``absolute_pos_embed``)
    through the JAX SwinIR's ``torch_key_rules`` give the JAX tree back, leaf
    for leaf."""
    jnet, params = _jax_net(name)
    state_dict = jax_params_to_state_dict(params, RULES)
    assert set(state_dict) == set(port_arch.SwinIR(**VARIANTS[name]).state_dict())
    if '3conv' in name:
        assert {'layers.0.conv.0.weight', 'layers.1.conv.2.bias',
                'layers.1.conv.4.weight'} <= set(state_dict)
        assert state_dict['layers.0.conv.2.weight'].shape == (6, 6, 1, 1)
    if 'ape' in name:
        assert state_dict['absolute_pos_embed'].shape == (1, SIZE * SIZE, 24)
    back = dict(_flatten(convert_torch_state_dict(state_dict, rules=jnet.torch_key_rules)))
    want = dict(_flatten(params))
    assert back.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg='.'.join(key))


def test_ape_takes_its_token_count_only():
    """BasicSR's embedding holds (img_size // patch_size)**2 tokens: with
    patch_size 2 and img_size 32, a 16x16 input; another size raises."""
    net = port_arch.SwinIR(**VARIANTS['ape-patch2']).eval()
    assert net.absolute_pos_embed.shape == (1, 256, 24)
    with torch.no_grad():
        assert net(torch.rand(1, 3, 16, 16)).shape == (1, 3, 32, 32)
        with pytest.raises(ValueError, match='position embedding holds 256'):
            net(torch.rand(1, 3, 24, 24))
    fresh = port_arch.SwinIR(**VARIANTS['ape'], generator=torch.Generator().manual_seed(0))
    pos = fresh.absolute_pos_embed
    assert 0 < pos.abs().max() <= 0.04 and abs(pos.std().item() - 0.02) < 0.004


# ---------------------------------------------------------- training routes
def _counted(monkeypatch):
    """Launch counts of the block kernels' wrappers (plain versions here)."""
    calls = dict.fromkeys(('swin_block_full_forward', 'swin_attn_block_forward',
                           'mlp_block_forward'), 0)
    for module, name in ((port_swin, 'swin_block_full_forward'),
                         (port_swin, 'swin_attn_block_forward'),
                         (port_mlp, 'mlp_block_forward')):
        real = getattr(module, name)

        def wrapper(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize('options, mode, want', [
    (dict(), 'train', (0, 4, 4)),
    (dict(drop_rate=0.1), 'train', (0, 4, 0)),
    (dict(attn_drop_rate=0.1), 'train', (0, 0, 0)),
    (dict(fused_attn=False), 'train', (0, 0, 0)),
    (dict(drop_rate=0.1, attn_drop_rate=0.1), 'eval', (4, 0, 0)),
    (dict(fused_attn=False), 'eval', (0, 0, 0)),
], ids=['kernels', 'drop-rate', 'attn-drop-rate', 'unfused', 'eval-rates', 'eval-unfused'])
def test_route_each_rate_selects(monkeypatch, options, mode, want):
    """(joint, attention branch, MLP branch) kernel calls of a forward of 4
    blocks: ``drop_rate`` keeps the attention branch's kernel and unfuses
    the MLP; attention dropout or ``fused_attn: false`` unfuse the block;
    eval with rates keeps the joint kernel."""
    calls = _counted(monkeypatch)
    net = port_arch.SwinIR(**_config(**options))
    net.train() if mode == 'train' else net.eval()
    with torch.no_grad():
        net(torch.rand(1, 3, SIZE, SIZE))
    assert (calls['swin_block_full_forward'], calls['swin_attn_block_forward'],
            calls['mlp_block_forward']) == want


def test_dropout_mask_share_scale_and_generator():
    """Entries kept at the rate set (40000 draws at p 0.25: within 0.01),
    kept ones scaled by 1 / keep, the identity in eval(), and the same
    masks again from the same seed."""
    drop = port_arch.Dropout(0.25)
    drop.generator = torch.Generator().manual_seed(3)
    x = torch.ones(200, 200)
    y = drop(x)
    assert torch.equal(y.unique(), torch.tensor([0., 1 / 0.75]))
    assert abs((y == 0).float().mean().item() - 0.25) < 0.01
    again = port_arch.Dropout(0.25)
    again.generator = torch.Generator().manual_seed(3)
    torch.testing.assert_close(again(x), y, rtol=0, atol=0)
    assert drop.eval()(x) is x
    assert port_arch.Dropout(0.).train()(x) is x


def _drop_net(**kw):
    net = port_arch.SwinIR(**_config(drop_rate=0.1, drop_path_rate=0.2, **kw),
                           generator=torch.Generator().manual_seed(4))
    return net.train()


def test_kernel_and_unfused_routes_draw_the_same_masks():
    """With ``drop_rate: 0.1`` (and DropPath 0.2), the attention branch's
    kernel with the unfused MLP against the whole unfused chain from the
    same generator state: both draw DropPath's scales, then ``proj_drop`` in
    the windows' layout, then the MLP's two masks, so the outputs and every
    gradient agree to float32 rounding (atol 1e-5 + rtol 1e-4; gradients to
    1e-4 of each tensor's largest entry)."""
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, SIZE, SIZE).astype(np.float32))
    outs, grads = [], []
    for fused_attn in (True, False):
        net = _drop_net(fused_attn=fused_attn)
        net.seed_drop_path(11)
        out = net(x)
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in net.named_parameters()})
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-4)
    for key, grad in grads[1].items():
        scale = grad.abs().max().item()
        assert (grads[0][key] - grad).abs().max().item() <= 1e-4 * scale + 1e-12, key
    with torch.no_grad():
        eval_out = net.eval()(x)
    assert (eval_out - outs[1]).abs().max() > 1e-3   # the masks did something


def test_drop_masks_come_from_the_models_generator_and_its_state(tmp_path):
    """``seed_drop_path`` hands every block and dropout the model's
    generator; the same seed repeats a training forward, and the ``.state``
    that ``SRModel`` saves restores it: the forward after a resume repeats
    the one after the save."""
    net = _drop_net(attn_drop_rate=0.1)
    gen = net.seed_drop_path(6)
    drops = [m for m in net.modules() if isinstance(m, port_arch.Dropout)]
    assert len(drops) == 1 + 4 * 3 and all(d.generator is gen for d in drops)
    x = torch.rand(1, 3, SIZE, SIZE)
    with torch.no_grad():
        first, second = net(x), net(x)
        net.seed_drop_path(6)
        again = net(x)
    assert not torch.equal(first, second)
    torch.testing.assert_close(first, again, rtol=0, atol=0)

    opt = {'name': 'drop_state', 'model_type': 'SwinIRModel', 'scale': 2, 'num_gpu': 0,
           'manual_seed': 7, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
           'network_g': dict(type='SwinIR', **_config(drop_rate=0.1, attn_drop_rate=0.1)),
           'path': {'pretrain_network_g': None, 'strict_load_g': True,
                    'models': str(tmp_path), 'training_states': str(tmp_path)},
           'train': {'ema_decay': 0, 'optim_g': {'type': 'Adam', 'lr': 1e-4},
                     'scheduler': {'type': 'MultiStepLR', 'milestones': [3], 'gamma': 0.5},
                     'total_iter': 10,
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}},
           'val': {'val_freq': 100}}
    model = build_model(copy.deepcopy(opt))
    model.net_g(x)   # the generator moves on
    model.save_training_state(0, 1)
    state = torch.load(tmp_path / '1.state', weights_only=True)
    assert 'drop_path_generator' in state
    with torch.no_grad():
        after_save = model.net_g(x)
        model.net_g(x)
    model.resume_training(state)
    with torch.no_grad():
        after_resume = model.net_g(x)
    torch.testing.assert_close(after_resume, after_save, rtol=0, atol=0)


@pytest.mark.parametrize('batch', [1, 2, 3, 4])
def test_drop_path_scales_reach_the_kernels_at_any_batch(batch):
    """DropPath's two scales are the rows of one (2, B) draw, so the second
    starts 4 B bytes in: the launch layer copies a row that is not 16-byte
    aligned (B not a multiple of 4) instead of refusing it, and hands the
    aligned one on as it is."""
    from basicsr4rs_torch.ops import _launch
    block = port_arch.SwinTransformerBlock(8, 2, 4, drop_path=0.5).train()
    block.generator = torch.Generator().manual_seed(batch)
    x = torch.zeros(batch, 4, 4, 8)
    for s in block.drop_path_scales(batch, x.device):
        got = _launch.scale_operand(s, x)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, s)
        assert (got.data_ptr() == s.data_ptr()) == (s.data_ptr() % 16 == 0)
