"""The port's diffusion UNets (basicsr4rs_torch/archs/unet_arch.py) and the
helpers under them against the JAX package, float32 on the CPU, same numpy
inputs, the JAX module's parameters (every leaf random, the zero-initialised
convolutions too) carried across by ``utils.jax_convert``. Blocks within 1e-5
absolute; whole networks and gradients within 1e-4 of the largest entry of
each tensor (float32 sums in another order through the whole network)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basicsr4rs_torch.archs import arch_util as port_util
from basicsr4rs_torch.archs import unet_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import arch_util as jax_util
from basicsr4rs_tpu.archs import unet_arch as ref
from basicsr4rs_tpu.ops import dispatch

from test_torch_swinir import _randomize

RULES = port.UNetModelSwin.JAX_KEY_RULES


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def nchw(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def jax_params(module, seed, *args, **kwargs):
    """The JAX module's parameter tree with every leaf random."""
    params = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params['params']))
    return _randomize(tree, np.random.RandomState(seed))


def carry(net, params, rules=RULES):
    net.load_state_dict(jax_params_to_state_dict(params, rules))
    return net.eval()


def assert_close_rel(got, want, rel, name='', floor=0.):
    """max|got - want| <= rel * max|want|, the scale no smaller than ``floor``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.abs(want).max() > 0, name
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), floor), name


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize('dim', [8, 9, 160])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 7, 14], np.int32)
    want = ref.timestep_embedding(jnp.asarray(t), dim)
    got = port.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('scale', [4.0, 2.0, 0.5, 1.0])
def test_resize_bicubic_is_torch_interpolate_and_matches_jax(scale):
    x = np.random.RandomState(0).randn(2, 3, 8, 12).astype(np.float32)
    got = port_util.resize_bicubic(torch.from_numpy(x), scale)
    want_torch = F.interpolate(torch.from_numpy(x), scale_factor=scale, mode='bicubic',
                               align_corners=False)
    assert torch.equal(got, want_torch)
    want = nchw(jax_util.resize_bicubic(nhwc(x), scale))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_resize_nearest_and_pixel_unshuffle():
    x = np.random.RandomState(1).randn(2, 3, 4, 6).astype(np.float32)
    got = port_util.resize_nearest(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, nchw(jax_util.resize_nearest(nhwc(x), 2)))
    got = port_util.pixel_unshuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, nchw(jax_util.pixel_unshuffle(nhwc(x), 2)))


@pytest.mark.parametrize('h, w, ws', [(8, 8, 4), (16, 8, 4), (16, 16, 8), (8, 24, 8)])
def test_resshift_shift_mask_is_exact(h, w, ws):
    """Both quirks of the reference mask (H-only regions, w-major tokens)."""
    want = ref._shift_attn_mask_resshift(h, w, ws, ws // 2)
    got = port.shift_attn_mask_resshift(h, w, ws, ws // 2)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got != 0).any()


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize('kw', [
    dict(use_scale_shift_norm=True), dict(use_scale_shift_norm=False),
    dict(use_scale_shift_norm=True, out_channels=16),
    dict(use_scale_shift_norm=False, out_channels=16, use_conv=True),
    dict(use_scale_shift_norm=True, down=True), dict(use_scale_shift_norm=False, up=True),
], ids=lambda kw: '-'.join(f'{k}={v}' for k, v in kw.items()))
def test_res_block(kw):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    emb = rng.randn(2, 32).astype(np.float32)
    jmod = ref.ResBlock(8, 32, **kw)
    params = jax_params(jmod, 3, nhwc(x), jnp.asarray(emb))
    want = nchw(jmod.apply({'params': params}, nhwc(x), jnp.asarray(emb)))
    net = carry(port.ResBlock(8, 32, **kw), params)
    got = net(torch.from_numpy(x), torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_res_block_conv_and_attention_block():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 6, 6).astype(np.float32)
    emb = rng.randn(2, 32).astype(np.float32)
    for kw in (dict(use_scale_shift_norm=True, out_channels=12), dict(down=True)):
        jmod = ref.ResBlockConv(8, 32, **kw)
        params = jax_params(jmod, 5, nhwc(x), jnp.asarray(emb))
        want = nchw(jmod.apply({'params': params}, nhwc(x), jnp.asarray(emb)))
        net = carry(port.ResBlockConv(8, 32, **kw), params)
        got = net(torch.from_numpy(x), torch.from_numpy(emb)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    jmod = ref.AttentionBlock(8, num_heads=2)
    params = jax_params(jmod, 6, nhwc(x))
    want = nchw(jmod.apply({'params': params}, nhwc(x)))
    got = carry(port.AttentionBlock(8, num_heads=2), params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def embed_table(table, small, full):
    """The (2*small-1)^2 bias table the JAX package makes for a shrunken
    window, at the rows the port reads in its (2*full-1)^2 table."""
    out = np.zeros(((2 * full - 1)**2, table.shape[1]), np.float32)
    for dy in range(-(small - 1), small):
        for dx in range(-(small - 1), small):
            out[(dy + full - 1) * (2 * full - 1) + dx + full - 1] = \
                table[(dy + small - 1) * (2 * small - 1) + dx + small - 1]
    return out


@pytest.mark.parametrize('size, shift', [(8, 0), (8, 2), (4, 2), (2, 2), (2, 0)],
                         ids=['plain', 'shifted', 'one-window-drops-shift',
                              'shrunken-window-shifted', 'shrunken-window'])
def test_swin_block_gn(size, shift):
    """Window 4: two windows a side, one window (the shift is dropped), and a
    2x2 map that shrinks the window to itself."""
    x = np.random.RandomState(7).randn(2, 16, size, size).astype(np.float32)
    jmod = ref.SwinBlockGN(16, 2, 4, shift, mlp_ratio=4.)
    params = jax_params(jmod, 8 + size + shift, nhwc(x))
    want = nchw(jmod.apply({'params': params}, nhwc(x)))
    carried = dict(params)
    if size < 4:
        carried['attn'] = dict(params['attn'], relative_position_bias_table=embed_table(
            params['attn']['relative_position_bias_table'], size, 4))
    net = carry(port.SwinBlockGN(16, 2, 4, shift, mlp_ratio=4.), carried)
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('size, shift', [(18, 4), (9, 0)],
                         ids=['window9-shifted', 'window9-one-window'])
def test_swin_block_gn_window9(size, shift):
    """Window 9 (81 tokens, as ``train_ResShift_L2S288.yml`` sets it): shifted
    by 4 on an 18x18 map, and one 9x9 window, unshifted."""
    x = np.random.RandomState(9).randn(1, 16, size, size).astype(np.float32)
    jmod = ref.SwinBlockGN(16, 2, 9, shift, mlp_ratio=4.)
    params = jax_params(jmod, 30 + size + shift, nhwc(x))
    want = nchw(jmod.apply({'params': params}, nhwc(x)))
    net = carry(port.SwinBlockGN(16, 2, 9, shift, mlp_ratio=4.), params)
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('patch_norm', [False, True])
def test_basic_layer(patch_norm):
    x = np.random.RandomState(9).randn(2, 12, 8, 8).astype(np.float32)
    jmod = ref.BasicLayer(12, 16, 2, 4, depth=2, mlp_ratio=4., patch_norm=patch_norm)
    params = jax_params(jmod, 10, nhwc(x))
    want = nchw(jmod.apply({'params': params}, nhwc(x)))
    net = carry(port.BasicLayer(12, 16, 2, 4, depth=2, mlp_ratio=4., patch_norm=patch_norm),
                params)
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ----------------------------------------------------------------- networks
SWIN = dict(image_size=16, in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
            attention_resolutions=(16, 8), channel_mult=(1, 2), num_head_channels=4,
            swin_embed_dim=8, window_size=4, mlp_ratio=4., use_scale_shift_norm=True,
            lq_size=16)
SWIN_VARIANTS = {
    'published-shape': SWIN,
    'lq-features-updown': dict(SWIN, lq_size=32, resblock_updown=True, num_res_blocks=[1, 2],
                               use_scale_shift_norm=False, patch_norm=True),
    'no-lq': dict(SWIN, cond_lq=False, conv_resample=False, attention_resolutions=(8,)),
}


def _swin_inputs(cfg, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    t = np.array([0, 3], np.int32)
    lq = (rng.randn(2, 3, cfg['lq_size'], cfg['lq_size']).astype(np.float32)
          if cfg.get('cond_lq', True) else None)
    return x, t, lq


@pytest.mark.parametrize('name', list(SWIN_VARIANTS))
def test_unet_model_swin_forward(name):
    cfg = SWIN_VARIANTS[name]
    x, t, lq = _swin_inputs(cfg)
    jnet = ref.UNetModelSwin(**cfg)
    kwargs = {} if lq is None else {'lq': nhwc(lq)}
    params = jax_params(jnet, 12, nhwc(x), jnp.asarray(t), **kwargs)
    want = nchw(jax.jit(lambda p: jnet.apply({'params': p}, nhwc(x), jnp.asarray(t),
                                             **kwargs))(params))
    net = carry(port.UNetModelSwin(**cfg), params)
    got = net(torch.from_numpy(x), torch.from_numpy(t),
              lq=None if lq is None else torch.from_numpy(lq)).detach().numpy()
    assert_close_rel(got, want, 1e-4)


def test_unet_model_swin_fresh_output_is_zero_and_published_keys():
    """The zero-initialised last convolution; BasicSR's key names."""
    net = port.UNetModelSwin(**SWIN, generator=torch.Generator().manual_seed(0))
    x, t, lq = _swin_inputs(SWIN)
    out = net(torch.from_numpy(x), torch.from_numpy(t), lq=torch.from_numpy(lq))
    assert out.shape == (2, 3, 16, 16) and out.abs().max() == 0
    keys = set(net.state_dict())
    for key in ('time_embed.0.weight', 'input_blocks.0.0.weight',
                'input_blocks.1.0.in_layers.0.weight', 'input_blocks.1.0.emb_layers.1.bias',
                'input_blocks.1.1.patch_embed.proj.weight',
                'input_blocks.1.1.blocks.1.attn.relative_position_bias_table',
                'input_blocks.1.1.blocks.0.mlp.fc1.weight', 'input_blocks.2.0.op.weight',
                'middle_block.1.patch_unembed.proj.bias', 'output_blocks.1.1.conv.weight',
                'out.2.weight'):
        assert key in keys, key
    assert net.state_dict()['input_blocks.1.1.blocks.0.mlp.fc1.weight'].dim() == 4


def test_unet_model_swin_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        port.UNetModelSwin(**SWIN, use_fp16=True)
    port.UNetModelSwin(**SWIN, dims=2, use_fp16=False)   # the published keys


def test_unet_model_swin_gradients_match_jax_kernels():
    """Every parameter's gradient of a mean-square loss against the JAX
    network with its window attention on the Pallas kernels
    (``force_interpret``), forward and backward."""
    x, t, lq = _swin_inputs(SWIN, seed=13)
    target = np.random.RandomState(14).randn(2, 3, 16, 16).astype(np.float32)
    jnet = ref.UNetModelSwin(**SWIN)
    params = jax_params(jnet, 15, nhwc(x), jnp.asarray(t), lq=nhwc(lq))

    def jax_loss(p):
        out = jnet.apply({'params': p}, nhwc(x), jnp.asarray(t), lq=nhwc(lq))
        return jnp.mean((out - nhwc(target))**2)

    with dispatch.force_interpret():
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.array, jax.device_get(want)), RULES)

    net = carry(port.UNetModelSwin(**SWIN), params).train()
    out = net(torch.from_numpy(x), torch.from_numpy(t), lq=torch.from_numpy(lq))
    loss = ((out - torch.from_numpy(target))**2).mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    # the bias of a convolution that a GroupNorm follows has a gradient of
    # exactly zero, and both sides hold float32 rounding noise there: such a
    # tensor is held to 1e-7 of the largest gradient of all instead
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for key, grad in got.items():
        assert_close_rel(grad.numpy(), want[key].numpy(), 1e-4, key, floor)


@pytest.mark.parametrize('kw', [dict(), dict(num_classes=5, resblock_updown=True)],
                         ids=['plain', 'classes-updown'])
def test_unet_model_forward(kw):
    cfg = dict(image_size=8, in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
               attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2,
               use_scale_shift_norm=True, **kw)
    rng = np.random.RandomState(16)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    lq = rng.randn(2, 3, 4, 4).astype(np.float32)   # resized bicubically to 8x8
    t = np.array([1, 2], np.int32)
    y = np.array([0, 4], np.int32)
    jnet = ref.UNetModel(**cfg)
    jkw = dict(lq=nhwc(lq), **({'y': jnp.asarray(y)} if kw else {}))
    params = jax_params(jnet, 17, nhwc(x), jnp.asarray(t), **jkw)
    want = nchw(jnet.apply({'params': params}, nhwc(x), jnp.asarray(t), **jkw))
    net = carry(port.UNetModel(**cfg), params)
    got = net(torch.from_numpy(x), torch.from_numpy(t), lq=torch.from_numpy(lq),
              y=torch.from_numpy(y).long() if kw else None).detach().numpy()
    assert_close_rel(got, want, 1e-4)


@pytest.mark.parametrize('unshuffle', [False, True])
def test_unet_model_conv_forward(unshuffle):
    cfg = dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
               channel_mult=(1, 2), use_scale_shift_norm=True)
    rng = np.random.RandomState(18)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    lq = rng.randn(2, 3, 16 if unshuffle else 8, 16 if unshuffle else 8).astype(np.float32)
    t = np.array([1, 2], np.int32)
    jnet = ref.UNetModelConv(**cfg)
    params = jax_params(jnet, 19, nhwc(x), jnp.asarray(t), lq=nhwc(lq))
    want = nchw(jnet.apply({'params': params}, nhwc(x), jnp.asarray(t), lq=nhwc(lq)))
    net = carry(port.UNetModelConv(**cfg, lq_channels=12 if unshuffle else 3), params)
    got = net(torch.from_numpy(x), torch.from_numpy(t), lq=torch.from_numpy(lq))
    assert_close_rel(got.detach().numpy(), want, 1e-4)
