"""The port's fused 3x3 convolution (basicsr4rs_torch/ops/conv3x3.py) against
the JAX package's: the Pallas kernel in interpret mode and its XLA reference,
on the same numpy inputs (NCHW / OIHW for the port, NHWC / HWIO for JAX).
Float32 on the CPU, where the port's wrapper runs its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import swinir_arch as port_arch
from basicsr4rs_torch.ops import conv3x3 as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_arch
from basicsr4rs_tpu.ops import conv3x3 as jax_conv
from basicsr4rs_tpu.ops.dispatch import force_interpret

EPILOGUES = [(False, None), (True, None), (False, 0.2), (True, 0.01)]


def _inputs(seed, b=2, cin=16, cout=12, h=16, w=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, h, w).astype(np.float32)
    weight = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    residual = rng.randn(b, cout, h, w).astype(np.float32)
    return x, weight, bias, residual


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _hwio(w):
    return jnp.asarray(w.transpose(2, 3, 1, 0))


@pytest.mark.parametrize('with_residual, slope', EPILOGUES)
@pytest.mark.parametrize('route', ['pallas_interpret', 'xla'])
def test_forward_matches_jax(route, with_residual, slope):
    """All four epilogue combinations against the Pallas kernel (interpret
    mode) and the XLA reference: 1e-5 relative to the largest output, float32
    sums over 9 x 16 terms in another order."""
    x, weight, bias, residual = _inputs(0)
    res = residual if with_residual else None
    jres = _nhwc(residual) if with_residual else None
    if route == 'xla':
        want = jax_conv._xla_conv3x3(_nhwc(x), _hwio(weight), jnp.asarray(bias), jres, slope)
    else:
        want = jax_conv.fused_conv3x3(_nhwc(x), _hwio(weight), jnp.asarray(bias), residual=jres,
                                      act_slope=slope, interpret=True)
    got = port.fused_conv3x3(torch.from_numpy(x), torch.from_numpy(weight),
                             torch.from_numpy(bias), None if res is None else torch.from_numpy(res),
                             slope).numpy()
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize('with_residual, slope', EPILOGUES)
def test_gradients_match_jax(with_residual, slope):
    """d/dx, d/dweight, d/dbias and d/dresidual of sum(out * cotangent)
    against ``jax.grad`` through the JAX op's own VJP (interpret mode); 1e-4
    of each gradient's largest entry (the weight gradient sums 768 terms)."""
    x, weight, bias, residual = _inputs(1)
    cot = np.random.RandomState(2).randn(2, 12, 16, 24).astype(np.float32)

    def jloss(x_, w_, b_, r_):
        out = jax_conv.fused_conv3x3(x_, w_, b_, residual=r_ if with_residual else None,
                                     act_slope=slope, interpret=True)
        return jnp.sum(out * _nhwc(cot))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(_nhwc(x), _hwio(weight), jnp.asarray(bias),
                                                   _nhwc(residual))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, weight, bias, residual)]
    out = port.fused_conv3x3(leaves[0], leaves[1], leaves[2],
                             leaves[3] if with_residual else None, slope)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves, allow_unused=True)
    want = [np.asarray(jgrads[0]).transpose(0, 3, 1, 2), np.asarray(jgrads[1]).transpose(3, 2, 0, 1),
            np.asarray(jgrads[2]), np.asarray(jgrads[3]).transpose(0, 3, 1, 2)]
    for name, g, w in zip(('x', 'weight', 'bias', 'residual'), grads, want):
        if name == 'residual' and not with_residual:
            assert g is None
            continue
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_odd_sizes_and_bfloat16():
    """Any H, W, Cin, Cout (here 9x33, 5 -> 7) and bfloat16 inputs with
    float32 accumulation: against ``F.conv2d`` in float64, within one
    bfloat16 step of the largest output."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 9, 33).astype(np.float32)).bfloat16()
    weight = torch.from_numpy((rng.randn(7, 5, 3, 3) / 6).astype(np.float32))
    bias = torch.from_numpy(rng.randn(7).astype(np.float32))
    got = port.fused_conv3x3(x, weight, bias, act_slope=0.2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 9, 33)
    want = torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(
        x.double(), weight.bfloat16().double(), bias.double(), padding=1), 0.2)
    assert (got.double() - want).abs().max() <= 2**-8 * want.abs().max()


def test_knob_and_counter(monkeypatch):
    """``SWIN_FUSED_CONV`` is read at every call, default off; a CPU call
    launches no kernel."""
    monkeypatch.delenv('SWIN_FUSED_CONV', raising=False)
    assert not port.conv_fusion_enabled()
    monkeypatch.setenv('SWIN_FUSED_CONV', '1')
    assert port.conv_fusion_enabled()
    monkeypatch.setenv('SWIN_FUSED_CONV', '0')
    assert not port.conv_fusion_enabled()
    before = port.fused_conv3x3.launches
    x, weight, bias, _ = _inputs(4)
    port.fused_conv3x3(torch.from_numpy(x), torch.from_numpy(weight), torch.from_numpy(bias))
    assert port.fused_conv3x3.launches == before


def _config(upsampler, upscale):
    return dict(img_size=16, patch_size=1, in_chans=3, embed_dim=18, depths=(2, 2),
                num_heads=(3, 3), window_size=8, mlp_ratio=2., upscale=upscale, img_range=1.,
                upsampler=upsampler, resi_connection='1conv')


@pytest.mark.parametrize('upsampler, upscale', [('pixelshuffle', 4), ('nearest+conv', 4),
                                                ('pixelshuffledirect', 2), ('', 1)])
def test_swinir_fused_conv_route_matches_jax(monkeypatch, upsampler, upscale):
    """SwinIR with ``SWIN_FUSED_CONV=1`` in both packages (the JAX one under
    ``force_interpret()``, so its convs run the Pallas kernel): the same
    output to atol 1e-4 / rtol 1e-4 (float32 sums in another order through 4
    Swin blocks and the convs), the number of fused calls the routing gives,
    and the same ``state_dict`` keys as the default route."""
    monkeypatch.setenv('SWIN_FUSED_CONV', '1')
    jnet = jax_arch.SwinIR(**_config(upsampler, upscale))
    rng = np.random.RandomState(5)
    x = rng.rand(1, 3, 16, 16).astype(np.float32)
    with force_interpret():
        params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))['params']
        params = jax.tree_util.tree_map(
            lambda v: (np.asarray(v) + 0.05 * rng.randn(*v.shape)).astype(np.float32),
            jax.device_get(params))
        want = np.asarray(jax.jit(lambda p, v: jnet.apply({'params': p}, v))(
            params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    net = port_arch.SwinIR(**_config(upsampler, upscale)).eval()
    keys = list(net.state_dict())
    net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES),
                        strict=True)
    calls = []
    real = port_arch.fused_conv3x3
    monkeypatch.setattr(port_arch, 'fused_conv3x3',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from basicsr4rs_torch.archs import arch_util
    monkeypatch.setattr(arch_util, 'fused_conv3x3',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)
    # 2 RSTB tails + conv_after_body, then the upsampler's own
    expected = {'pixelshuffle': 3 + 1 + 2, 'nearest+conv': 3 + 1 + 3, 'pixelshuffledirect': 3,
                '': 3}[upsampler]
    assert len(calls) == expected
    assert list(net.state_dict()) == keys
    monkeypatch.setenv('SWIN_FUSED_CONV', '0')
    with torch.no_grad():
        default = net(torch.from_numpy(x)).numpy()
    assert len(calls) == expected
    np.testing.assert_allclose(got, default, atol=1e-5, rtol=1e-5)
