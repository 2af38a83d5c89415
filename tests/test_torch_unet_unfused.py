"""The ResShift UNet's unfused Swin route (``fused_attn: false``,
basicsr4rs_torch/archs/unet_arch.py): each ``SwinBlockGN`` partitions its
GroupNorm'd, rolled map into windows and runs SwinIR's
``WindowAttention.forward`` with the ResShift shift mask. Held against the
JAX package's ``fused_attn=False`` modules (their XLA chain) and against the
port's own fused route (the window-attention kernel's plain version on the
CPU), forward and every parameter's gradient, float32, on one set of random
weights carried across by ``utils.jax_convert``. Blocks within 1e-5
absolute; networks and gradients within 1e-4 of the largest entry of each
tensor (``F32_TOL`` of ``tests/test_torch_unet.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import unet_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import unet_arch as ref

from test_torch_swinir import _randomize
from test_torch_unet import (RULES, SWIN, _swin_inputs, assert_close_rel, carry, jax_params, nchw,
                             nhwc)


@pytest.mark.parametrize('size, shift', [(8, 2), (8, 0), (4, 2)],
                         ids=['shifted', 'plain', 'one-window-drops-shift'])
def test_swin_block_gn_unfused(size, shift):
    """Window 4 on an 8x8 map shifted by 2 (the ResShift mask), unshifted,
    and one window: against the JAX block's XLA chain and the port's fused
    block on the same weights."""
    x = np.random.RandomState(21).randn(2, 16, size, size).astype(np.float32)
    jmod = ref.SwinBlockGN(16, 2, 4, shift, mlp_ratio=4., fused_attn=False)
    params = jax_params(jmod, 22 + size + shift, nhwc(x))
    want = nchw(jmod.apply({'params': params}, nhwc(x)))
    net = carry(port.SwinBlockGN(16, 2, 4, shift, mlp_ratio=4., fused_attn=False), params)
    fused = carry(port.SwinBlockGN(16, 2, 4, shift, mlp_ratio=4.), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        got_fused = fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, got_fused, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_unet():
    """The JAX network with ``fused_attn=False`` and its parameters, every
    leaf random (shapes from ``jax.eval_shape``, no init)."""
    x, t, lq = _swin_inputs(SWIN)
    jnet = ref.UNetModelSwin(**SWIN, fused_attn=False)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), nhwc(x), jnp.asarray(t),
                                              lq=nhwc(lq)))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes['params'])
    return jnet, _randomize(zeros, np.random.RandomState(23))


def _nets(params):
    unfused = port.UNetModelSwin(**SWIN, fused_attn=False)
    fused = port.UNetModelSwin(**SWIN)
    for net in (unfused, fused):
        net.load_state_dict(jax_params_to_state_dict(params, RULES))
    return unfused.eval(), fused.eval()


def test_unet_model_swin_unfused_forward():
    """Attention at 16 (4 windows a side, the second block shifted by 2) and
    at 8 and in the middle (2 a side, shifted)."""
    jnet, params = _jax_unet()
    x, t, lq = _swin_inputs(SWIN, seed=24)
    want = nchw(jax.jit(lambda p: jnet.apply({'params': p}, nhwc(x), jnp.asarray(t),
                                             lq=nhwc(lq)))(params))
    unfused, fused = _nets(params)
    args = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        got = unfused(*args, lq=torch.from_numpy(lq)).numpy()
        got_fused = fused(*args, lq=torch.from_numpy(lq)).numpy()
    assert_close_rel(got, want, 1e-4)
    assert_close_rel(got, got_fused, 1e-4)


def test_unet_model_swin_unfused_gradients():
    """Every parameter's gradient of a mean-square loss: the port's unfused
    route against the JAX one and against the port's fused route; a tensor
    whose gradient is float32 noise (a bias that a GroupNorm cancels) is held
    to 1e-3 of the largest gradient of all instead, as in
    ``tests/test_torch_unet.py``."""
    jnet, params = _jax_unet()
    x, t, lq = _swin_inputs(SWIN, seed=25)
    target = np.random.RandomState(26).randn(2, 3, 16, 16).astype(np.float32)

    def jax_loss(p):
        out = jnet.apply({'params': p}, nhwc(x), jnp.asarray(t), lq=nhwc(lq))
        return jnp.mean((out - nhwc(target))**2)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, jax.device_get(want)),
                                    RULES)
    grads = []
    for net in _nets(params):
        out = net.train()(torch.from_numpy(x), torch.from_numpy(t), lq=torch.from_numpy(lq))
        loss = ((out - torch.from_numpy(target))**2).mean()
        loss.backward()
        assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
        grads.append({k: p.grad for k, p in net.named_parameters()})
    got, got_fused = grads
    assert got.keys() == want.keys() == got_fused.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for key, grad in got.items():
        assert_close_rel(grad.numpy(), want[key].numpy(), 1e-4, key, floor)
        assert_close_rel(grad.numpy(), got_fused[key].numpy(), 1e-4, key, floor)
