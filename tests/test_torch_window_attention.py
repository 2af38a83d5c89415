"""The plain versions of the window-attention kernels
(basicsr4rs_torch/ops/window_attention.py) against the JAX package: its
Pallas kernels run in interpret mode inside ``jax.jit``, and its XLA
reference. Float32 on the CPU, where the port's wrappers run the plain
versions through the same ``torch.autograd.Function`` that launches the CUDA
kernels on a card. Tolerance 1e-5 absolute: float32 sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.ops import window_attention as port
from basicsr4rs_tpu.ops import dispatch
from basicsr4rs_tpu.ops import window_attention as ref

TOL = 1e-5
# (B, H, W, C, heads, window, bias windows: 1 or all)
CASES = [
    pytest.param(2, 8, 8, 64, 2, 4, 1, id='hd32-broadcast'),
    pytest.param(2, 8, 8, 64, 2, 4, 4, id='hd32-masked'),
    pytest.param(1, 8, 16, 60, 2, 4, 1, id='hd30-broadcast'),
    pytest.param(2, 8, 16, 60, 2, 4, 8, id='hd30-masked'),
    pytest.param(1, 8, 8, 64, 2, 8, 1, id='ws8-one-window'),
    pytest.param(1, 9, 18, 64, 2, 9, 1, id='ws9-broadcast'),
    pytest.param(1, 9, 18, 64, 2, 9, 2, id='ws9-masked'),
]


def _inputs(b, h, w, c, heads, ws, nwb, seed=0):
    rng = np.random.RandomState(seed)
    n = ws * ws
    qkv = rng.randn(b, h, w, 3 * c).astype(np.float32)
    bias = (0.5 * rng.randn(nwb, heads, n, n)).astype(np.float32)
    if nwb > 1:   # a shift mask's -100 entries on top of the bias
        bias += np.where(rng.rand(nwb, 1, n, n) < 0.3, -100., 0.).astype(np.float32)
    dout = rng.randn(b, h, w, c).astype(np.float32)
    return qkv, bias, dout, (c // heads)**-0.5


def _jax_outputs(fn, qkv, bias, dout, ws, heads, scale):
    def run(qkv, bias):
        out, vjp = jax.vjp(lambda q, b_: fn(q, b_, ws, heads, scale), qkv, bias)
        return (out,) + vjp(jnp.asarray(dout))
    return [np.asarray(a) for a in jax.jit(run)(jnp.asarray(qkv), jnp.asarray(bias))]


def _port_outputs(qkv, bias, dout, ws, heads, scale):
    q = torch.from_numpy(qkv).requires_grad_()
    b_ = torch.from_numpy(bias).requires_grad_()
    out = port.fused_window_attention(q, b_, ws, heads, scale)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy(), q.grad.numpy(), b_.grad.numpy()]


@pytest.mark.parametrize('b, h, w, c, heads, ws, nwb', CASES)
def test_matches_pallas_kernels_in_interpret_mode(b, h, w, c, heads, ws, nwb):
    qkv, bias, dout, scale = _inputs(b, h, w, c, heads, ws, nwb)
    with dispatch.force_interpret():
        want = _jax_outputs(ref.fused_window_attention, qkv, bias, dout, ws, heads, scale)
    got = _port_outputs(qkv, bias, dout, ws, heads, scale)
    for name, g, w_ in zip(('out', 'dqkv', 'dbias'), got, want):
        assert g.shape == w_.shape, name
        np.testing.assert_allclose(g, w_, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('b, h, w, c, heads, ws, nwb', CASES)
def test_matches_xla_reference(b, h, w, c, heads, ws, nwb):
    qkv, bias, dout, scale = _inputs(b, h, w, c, heads, ws, nwb, seed=1)
    want = _jax_outputs(ref.reference_window_attention, qkv, bias, dout, ws, heads, scale)
    got = _port_outputs(qkv, bias, dout, ws, heads, scale)
    for name, g, w_ in zip(('out', 'dqkv', 'dbias'), got, want):
        np.testing.assert_allclose(g, w_, atol=TOL, rtol=0, err_msg=name)


def test_backward_wrapper_matches_autograd_of_the_forward():
    """``window_attention_backward`` alone (what a card runs as one kernel)
    returns what autograd through ``reference_window_attention`` returns."""
    qkv, bias, dout, scale = _inputs(2, 8, 8, 64, 2, 4, 4, seed=2)
    args = [torch.from_numpy(a) for a in (qkv, bias, dout)]
    dqkv, dbias = port.window_attention_backward(*args, 4, 2, scale)
    _, want_dqkv, want_dbias = _port_outputs(qkv, bias, dout, 4, 2, scale)
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=1e-6)
    np.testing.assert_allclose(dbias.numpy(), want_dbias, atol=1e-6)
    assert dbias.dtype == torch.float32 and dbias.shape == args[1].shape


def test_bfloat16_keeps_dtype_and_float32_softmax():
    qkv, bias, dout, scale = _inputs(1, 8, 8, 64, 2, 4, 1, seed=3)
    q16 = torch.from_numpy(qkv).bfloat16()
    out = port.window_attention_forward(q16, torch.from_numpy(bias), 4, 2, scale)
    assert out.dtype == torch.bfloat16
    want = port.reference_window_attention(q16.float(), torch.from_numpy(bias), 4, 2, scale)
    assert (out.float() - want).abs().max() <= 1.6e-2 * want.abs().max()


def test_no_launch_is_counted_on_the_cpu():
    qkv, bias, dout, scale = _inputs(1, 4, 4, 8, 2, 4, 1)
    before = (port.window_attention_forward.launches, port.window_attention_backward.launches)
    _port_outputs(qkv, bias, dout, 4, 2, scale)
    assert before == (port.window_attention_forward.launches,
                      port.window_attention_backward.launches)


@pytest.mark.parametrize('kwargs, message', [
    (dict(ws=10, h=10, c=8, heads=2), 'more than 96 tokens'),
    (dict(ws=4, h=8, c=260, heads=2), 'head dim'),
    (dict(ws=4, h=6, c=8, heads=2), 'not a multiple'),
    (dict(ws=4, h=8, c=8, heads=2, nwb=3), 'bias must be'),
])
def test_unsupported_shapes_raise(kwargs, message):
    """The operand checks that guard a launch: a window above 96 tokens
    (10x10; 9x9 is taken), a head above 64 channels, a map the window does not tile, a bias of the wrong
    leading size. No fallback."""
    ws, h, c, heads = (kwargs[k] for k in ('ws', 'h', 'c', 'heads'))
    nwb = kwargs.get('nwb', 1)
    qkv = torch.zeros(1, h, h, 3 * c)
    bias = torch.zeros(nwb, heads, ws * ws, ws * ws)
    with pytest.raises(ValueError, match=message):
        port._operands('window_attention_fwd', qkv, bias, ws, heads)


@pytest.mark.parametrize('op', ['window_attention_fwd', 'window_attention_bwd'])
def test_binding_matches_the_c_signature(monkeypatch, op):
    """The wrapper's ctypes types are the kernel's C parameters, one for one:
    the launch, the shared-memory query (the dtype first) and the grid query
    of each kernel. A count that differs passes a pointer as an int, or fails
    at the first launch on the card."""
    import ctypes
    import re
    import types

    from basicsr4rs_torch.ops import _build, _launch

    class Fn(types.SimpleNamespace):
        def __call__(self, *args):
            return 0

    fake = types.SimpleNamespace(**{n: Fn() for n in (
        op, f'{op}_error', f'{op}_smem_bytes', f'{op}_plan')})
    monkeypatch.setattr(_launch, 'load_library', lambda _: fake)
    monkeypatch.setattr(_launch, 'check_shared_memory', lambda *args: None)
    port._checked_lib.cache_clear()
    try:
        port._checked_lib(op, torch.float32, 64, 2, 9, torch.device('cpu'))
    finally:
        port._checked_lib.cache_clear()
    source = (_build.CSRC_DIR / f'{op}.cu').read_text()
    kinds = {'int': ctypes.c_int, 'float': ctypes.c_float}

    def declared(name, ret):
        params = re.search(rf'\b{ret} {name}\(([^)]*)\)', source).group(1)
        return [ctypes.c_void_p if '*' in p else kinds[p.split()[0]] for p in params.split(',')]

    assert list(getattr(fake, op).argtypes) == declared(op, 'int')
    assert list(getattr(fake, f'{op}_smem_bytes').argtypes) == declared(f'{op}_smem_bytes', 'size_t')
    assert list(getattr(fake, f'{op}_plan').argtypes) == declared(f'{op}_plan', 'int')
