"""The training forward of the port's SwinIR
(basicsr4rs_torch/archs/swinir_arch.py): gradients of a whole small network
against the JAX package's, whose Swin blocks run through their Pallas
kernels in interpret mode, and DropPath folded into the split pair. Float32
on the CPU, where the port's kernel wrappers run their plain versions
through the same ``torch.autograd.Function`` that launches the CUDA kernels
on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import swinir_arch as port_arch
from basicsr4rs_torch.ops import mlp_block as port_mlp
from basicsr4rs_torch.ops import swin_block as port_swin
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_arch
from basicsr4rs_tpu.ops import dispatch

from test_torch_swinir import _randomize

SIZE = 16


def _config(window_size, drop_path_rate=0., size=SIZE):
    """2 RSTBs of 2 blocks (one plain, one shifted with the mask each)."""
    return dict(img_size=size, patch_size=1, in_chans=3, embed_dim=24, depths=(2, 2),
                num_heads=(2, 2), window_size=window_size, mlp_ratio=2., upscale=2,
                img_range=1., upsampler='pixelshuffle', resi_connection='1conv',
                drop_path_rate=drop_path_rate)


def grads_to_state_dict(grads):
    """A tree of gradients (or of EMA parameters) of the JAX package's SwinIR
    under the port's keys and layouts: the map that carries the weights
    carries them too."""
    tree = jax.tree_util.tree_map(np.array, jax.device_get(grads))
    return jax_params_to_state_dict(tree, port_arch.SwinIR.JAX_KEY_RULES)


@pytest.mark.parametrize('window_size, size', [(4, 8), (8, 16)])
def test_whole_model_gradients_match_jax_kernels(window_size, size):
    """Loss and every parameter's gradient of an L1 loss on a batch of 2
    maps of 2x2 windows, ``drop_path_rate=0``, against the JAX model with
    every fused site on its Pallas kernel (``force_interpret``). Tolerance: atol 2e-5 + rtol 2e-3 per
    entry, float32 sums in another order through 4 blocks and 7 convolutions
    (gradients of the mean L1 loss are of order 1e-3)."""
    cfg = _config(window_size, size=size)
    jnet = jax_arch.SwinIR(**cfg)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x0)['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(window_size))
    rng = np.random.RandomState(1)
    lq = rng.rand(2, 3, size, size).astype(np.float32)
    gt = rng.rand(2, 3, 2 * size, 2 * size).astype(np.float32)

    def jax_loss(p):
        out = jnet.apply({'params': p}, jnp.asarray(lq.transpose(0, 2, 3, 1)),
                         deterministic=False, rngs={'dropout': jax.random.PRNGKey(0)})
        return jnp.abs(out - jnp.asarray(gt.transpose(0, 2, 3, 1))).mean()

    with dispatch.force_interpret():   # jitted: one compilation instead of one per op
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = grads_to_state_dict(want)

    net = port_arch.SwinIR(**cfg).train()
    net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES))
    loss = (net(torch.from_numpy(lq)) - torch.from_numpy(gt)).abs().mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    for key, grad in got.items():
        assert grad.abs().max() > 0, key
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(), atol=2e-5, rtol=2e-3,
                                   err_msg=key)


def _block(drop_path, shift_size=4, seed=0):
    block = port_arch.SwinTransformerBlock(24, 2, window_size=8, shift_size=shift_size,
                                           mlp_ratio=2., drop_path=drop_path)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + (1. if p.dim() == 1 else 0.))
    return block.train()


def _branches(block, x, size):
    """The block's attention branch of x and the function that gives the
    MLP branch of y, both unfolded: plain versions, rolls written out."""
    h, w = size
    b, _, c = x.shape
    shift = block.shift_size
    attn = block.attn
    mask = port_arch._shift_attn_mask(h, w, 8, shift, x.device) if shift else None

    def rolled(t, s):
        t = t.reshape(b, h, w, c)
        return torch.roll(t, (s, s), dims=(1, 2)) if shift else t

    a = port_swin.reference_swin_attn_block(
        rolled(x, -shift), block.norm1.weight, block.norm1.bias, attn.qkv.weight, attn.qkv.bias,
        attn.proj.weight, attn.proj.bias, attn.relative_position_bias(8), mask, 8,
        attn.num_heads, attn.scale)
    a = rolled(a, shift).reshape(b, h * w, c)

    def mlp(y):
        return port_mlp.reference_mlp_block(y, block.norm2.weight, block.norm2.bias,
                                            block.mlp.fc1.weight, block.mlp.fc1.bias,
                                            block.mlp.fc2.weight, block.mlp.fc2.bias)
    return a, mlp


@pytest.mark.parametrize('shift_size', [0, 4])
def test_injected_scales_fold_into_the_pair(shift_size):
    """With (s1, s2) given, a training block is y = x + s1[b] attn(x), then
    y + s2[b] mlp(y); a sample whose scales are 0 passes through untouched.
    atol 1e-5: the same float32 arithmetic, folded at another place."""
    block = _block(0.1, shift_size)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 16 * 24, 24).astype(np.float32))
    s1 = torch.tensor([0., 1.25, 1.25])
    s2 = torch.tensor([0., 0., 1.25])
    with torch.no_grad():
        got = block(x, (16, 24), residual_scales=(s1, s2))
        a, mlp = _branches(block, x, (16, 24))
        y = x + s1[:, None, None] * a
        want = y + s2[:, None, None] * mlp(y)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), x[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), y[1].numpy())


def test_no_drop_path_folds_the_plain_residual():
    """``drop_path == 0`` in train() equals eval(): both are x + attn, + mlp."""
    block = _block(0.)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16 * 16, 24).astype(np.float32))
    with torch.no_grad():
        train_out = block(x, (16, 16))
        eval_out = block.eval()(x, (16, 16))
    assert block.train().drop_path_scales(2, x.device) is None
    np.testing.assert_allclose(train_out.numpy(), eval_out.numpy(), atol=1e-5, rtol=1e-5)


def test_drop_path_scales_come_from_the_models_generator():
    """The same seed gives the same masks; scales are 0 or 1 / keep, kept
    at the rate set (20000 draws at keep 0.8: within 0.02); eval() draws
    nothing; the rates rise linearly over the blocks from 0."""
    net = port_arch.SwinIR(**_config(8, drop_path_rate=0.3))
    blocks = [m for m in net.modules() if isinstance(m, port_arch.SwinTransformerBlock)]
    np.testing.assert_allclose([b.drop_path for b in blocks], np.linspace(0, 0.3, 4))
    net.seed_drop_path(5)
    assert all(b.generator is net.drop_path_generator for b in blocks)
    x = torch.from_numpy(np.random.RandomState(4).rand(4, 3, SIZE, SIZE).astype(np.float32))
    with torch.no_grad():
        first = net.train()(x)
        second = net(x)
        net.seed_drop_path(5)
        again = net(x)
    assert not torch.equal(first, second)
    torch.testing.assert_close(first, again, rtol=0, atol=0)

    block = blocks[-1]
    block.drop_path = 0.2
    s1, s2 = block.drop_path_scales(10000, x.device)
    s = torch.cat([s1, s2])
    assert s.dtype == torch.float32 and s1.shape == (10000,)
    assert set(s.unique().tolist()) == {0., 1.25}
    assert abs((s > 0).float().mean().item() - 0.8) < 0.02
    assert block.eval().drop_path_scales(4, x.device) is None


def test_training_forward_after_an_inference_mode_forward():
    """The cached window index and shift mask are made by the first forward,
    here under ``torch.inference_mode()`` as in a validation; a training
    step afterwards saves them for backward."""
    port_arch._relative_position_index.cache_clear()
    port_arch._shift_attn_mask.cache_clear()
    net = port_arch.SwinIR(**_config(8))
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 3, SIZE, SIZE).astype(np.float32))
    with torch.inference_mode():
        net.eval()(x)
    net.train()(x).mean().backward()
    assert all(p.grad is not None for p in net.parameters())


# ------------------------------------------------- SWIN_JOINT_TRAIN=1: the joint VJP
def _model_grads(net, lq, gt, scales=None):
    net.zero_grad(set_to_none=True)
    if scales is not None:      # the same DropPath scales in every block and every run
        for m in net.modules():
            if isinstance(m, port_arch.SwinTransformerBlock):
                m.drop_path_scales = lambda batch, device: scales
    loss = (net(lq) - gt).abs().mean()
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize('scaled', [False, True], ids=['residual', 'drop_path_scales'])
def test_joint_train_gradients_match_the_split_route(monkeypatch, scaled):
    """With ``SWIN_JOINT_TRAIN=1`` a training block is one call of
    ``fused_swin_block_full`` whose backward recomputes y and runs the MLP's
    and the attention branch's backward with the residual (or DropPath's
    scale) folded: the same loss and gradients as the split pair, to 1e-6 of
    each gradient's largest entry (the same arithmetic, y recomputed), and
    one joint forward, one attention forward, one MLP backward and one
    attention backward per block, no MLP forward."""
    cfg = _config(8, drop_path_rate=0.2 if scaled else 0.)
    net = port_arch.SwinIR(**cfg, generator=torch.Generator().manual_seed(3)).train()
    rng = np.random.RandomState(4)
    lq = torch.from_numpy(rng.rand(2, 3, SIZE, SIZE).astype(np.float32))
    gt = torch.from_numpy(rng.rand(2, 3, 2 * SIZE, 2 * SIZE).astype(np.float32))
    scales = (torch.tensor([1.25, 0.]), torch.tensor([0., 1.25])) if scaled else None
    monkeypatch.delenv('SWIN_JOINT_TRAIN', raising=False)
    assert not port_swin.joint_train_enabled()
    split_loss, split = _model_grads(net, lq, gt, scales)

    monkeypatch.setenv('SWIN_JOINT_TRAIN', '1')
    assert port_swin.joint_train_enabled()
    calls = {name: 0 for name in ('swin_block_full_forward', 'swin_attn_block_forward',
                                  'swin_attn_block_backward', 'mlp_block_backward')}

    def counted(name):
        real = getattr(port_swin, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(port_swin, name, counted(name))
    mlp_forward = []
    monkeypatch.setattr(port_mlp, 'mlp_block_forward',
                        lambda *a, **k: mlp_forward.append(1))
    joint_loss, joint = _model_grads(net, lq, gt, scales)
    assert calls == dict.fromkeys(calls, 4) and not mlp_forward
    assert joint_loss == pytest.approx(split_loss, rel=1e-6)
    for key, grad in split.items():
        assert np.abs(joint[key].numpy() - grad.numpy()).max() <= 1e-6 * grad.abs().max() + 1e-12, key


def test_joint_train_gradients_match_jax_joint_vjp(monkeypatch):
    """The same network under ``SWIN_JOINT_TRAIN=1`` in both packages, the
    JAX one with every fused site on its Pallas kernel (``force_interpret``):
    loss to 1e-5, every gradient to atol 2e-5 + rtol 2e-3, the bound of the
    split route's test above."""
    monkeypatch.setenv('SWIN_JOINT_TRAIN', '1')
    cfg = _config(8)
    jnet = jax_arch.SwinIR(**cfg)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(5))
    rng = np.random.RandomState(6)
    lq = rng.rand(2, 3, SIZE, SIZE).astype(np.float32)
    gt = rng.rand(2, 3, 2 * SIZE, 2 * SIZE).astype(np.float32)

    def jax_loss(p):
        out = jnet.apply({'params': p}, jnp.asarray(lq.transpose(0, 2, 3, 1)),
                         deterministic=False, rngs={'dropout': jax.random.PRNGKey(0)})
        return jnp.abs(out - jnp.asarray(gt.transpose(0, 2, 3, 1))).mean()

    with dispatch.force_interpret():
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = grads_to_state_dict(want)
    net = port_arch.SwinIR(**cfg).train()
    net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES))
    joint = []
    real = port_swin.swin_block_full_forward
    monkeypatch.setattr(port_swin, 'swin_block_full_forward',
                        lambda *a, **k: joint.append(1) or real(*a, **k))
    loss, got = _model_grads(net, torch.from_numpy(lq), torch.from_numpy(gt))
    assert len(joint) == 4
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for key, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(), atol=2e-5, rtol=2e-3,
                                   err_msg=key)


def test_joint_block_scales_match_jax_kernel():
    """K1 with per-sample scales: the port's joint block with (s1, s2)
    against the JAX kernel in interpret mode with ``residual_scales``; atol
    5e-5, rtol 1e-4, the bound of the unscaled block's test."""
    from basicsr4rs_tpu.ops import swin_block as jax_swin
    from test_torch_swin_block import HEADS, SCALE, _case, _jax_args, _port_args
    case = _case(8, True, seed=31)
    s1, s2 = np.array([0., 1.25], np.float32), np.array([1.25, 0.5], np.float32)
    got = port_swin.fused_swin_block_full(
        *_port_args(case), 8, HEADS, SCALE,
        residual_scales=(torch.from_numpy(s1), torch.from_numpy(s2))).numpy()
    want = jax_swin.fused_swin_block_full(*_jax_args(case), 8, HEADS, SCALE, interpret=True,
                                          residual_scales=(jnp.asarray(s1), jnp.asarray(s2)))
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-4)
