"""The deformable sampler's plain versions (basicsr4rs_torch/ops/dcn.py)
against the JAX package: ``modulated_deform_conv`` with ``method='gather'``
and with its Pallas kernels in interpret mode (inside ``jax.jit``), and
``flow_warp`` under ``dispatch.force_interpret()``.

On the CPU the port's wrappers run the plain versions through the same
``torch.autograd.Function`` that launches the CUDA kernels on a card.
Float32 values agree within 1e-5 and gradients within 1e-4 (absolute plus
relative; float32 sums in another order), the tolerances of
``tests/test_ops/test_dcn.py``. With bfloat16 activations the two packages
round at different places (the JAX package multiplies the mask into the
rounded samples, the port rounds once after it): 2e-2, a few bfloat16 ulps
of values up to about 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import arch_util as port_util
from basicsr4rs_torch.ops import dcn as port
from basicsr4rs_tpu.archs import arch_util as ref_util
from basicsr4rs_tpu.ops import dcn as ref
from basicsr4rs_tpu.ops import dispatch

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _case(seed, n, h, w, cin, cout, dg=1, stride=1, dilation=1, groups=1, offset_scale=3.0,
          with_mask=True, with_bias=True):
    """NHWC / HWIO numpy inputs of one DCN call, and its settings."""
    rng = np.random.RandomState(seed)
    ho = (h + 2 - dilation * 2 - 1) // stride + 1
    wo = (w + 2 - dilation * 2 - 1) // stride + 1
    arrays = dict(
        x=rng.rand(n, h, w, cin).astype(np.float32),
        offset=(rng.randn(n, ho, wo, 2 * dg * 9) * offset_scale).astype(np.float32),
        mask=rng.rand(n, ho, wo, dg * 9).astype(np.float32) if with_mask else None,
        weight=rng.rand(3, 3, cin // groups, cout).astype(np.float32),
        bias=rng.randn(cout).astype(np.float32) if with_bias else None,
        dout=rng.randn(n, ho, wo, cout).astype(np.float32))
    settings = dict(stride=stride, padding=1, dilation=dilation, groups=groups, deform_groups=dg)
    return arrays, settings


def _jax_outputs(arrays, settings, method, dtype=jnp.float32):
    """(out, dx, doffset, dmask, dweight, dbias) of the JAX package, as
    float32 numpy in the JAX layout; None where the input is None."""
    names = [k for k in ('x', 'offset', 'mask', 'weight', 'bias') if arrays[k] is not None]

    def run(*args):
        given = dict(zip(names, args))

        def fn(*inner):
            kw = dict(zip(names, inner))
            return ref.modulated_deform_conv(
                kw['x'].astype(dtype), kw['offset'].astype(dtype),
                None if 'mask' not in kw else kw['mask'].astype(dtype), kw['weight'],
                kw.get('bias'), method=method, **settings)
        out, vjp = jax.vjp(fn, *[given[k] for k in names])
        return (out,) + vjp(jnp.asarray(arrays['dout']).astype(out.dtype))

    got = jax.jit(run)(*[jnp.asarray(arrays[k]) for k in names])
    got = [np.asarray(a.astype(jnp.float32)) for a in got]
    result = {'out': got[0]}
    result.update({f'd{k}': g for k, g in zip(names, got[1:])})
    return result


def _port_outputs(arrays, settings, dtype=torch.float32):
    """The same through the port, converted back to the JAX layout."""
    t = {}
    for k in ('x', 'offset', 'mask'):
        if arrays[k] is not None:
            t[k] = torch.from_numpy(_nchw(arrays[k])).requires_grad_()
    t['weight'] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(arrays['weight'], (3, 2, 0, 1)))).requires_grad_()
    if arrays['bias'] is not None:
        t['bias'] = torch.from_numpy(arrays['bias'].copy()).requires_grad_()
    out = port.modulated_deform_conv(
        t['x'].to(dtype), t['offset'].to(dtype),
        None if 'mask' not in t else t['mask'].to(dtype), t['weight'], t.get('bias'), **settings)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(_nchw(arrays['dout'])).to(dtype))
    result = {'out': _nhwc(out.detach().float().numpy())}
    for k in ('x', 'offset', 'mask'):
        if k in t:
            result[f'd{k}'] = _nhwc(t[k].grad.numpy())
    result['dweight'] = np.transpose(t['weight'].grad.numpy(), (2, 3, 1, 0))
    if 'bias' in t:
        result['dbias'] = t['bias'].grad.numpy()
    return result


def _compare(got, want, value_tol=VALUE_TOL, grad_tol=GRAD_TOL):
    assert set(got) == set(want)
    for name in want:
        tol = value_tol if name == 'out' else grad_tol
        scale = max(1., float(np.abs(want[name]).max()))
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol * scale,
                                   err_msg=name)


CASES = [
    pytest.param(dict(seed=9, n=2, h=9, w=11, cin=4, cout=6, dg=1), id='dg1-odd-map'),
    pytest.param(dict(seed=9, n=2, h=9, w=11, cin=4, cout=6, dg=2), id='dg2-odd-map'),
    pytest.param(dict(seed=11, n=1, h=12, w=14, cin=4, cout=6, dg=2, stride=2,
                      offset_scale=2.0), id='stride2'),
    pytest.param(dict(seed=11, n=1, h=12, w=14, cin=4, cout=6, dg=2, dilation=2,
                      offset_scale=2.0), id='dilation2'),
    pytest.param(dict(seed=12, n=2, h=8, w=8, cin=8, cout=8, dg=2, groups=2,
                      offset_scale=1.0), id='groups2'),
    pytest.param(dict(seed=14, n=1, h=8, w=10, cin=4, cout=4, dg=2, with_mask=False),
                 id='no-mask'),
    pytest.param(dict(seed=15, n=1, h=8, w=8, cin=4, cout=4, dg=1, with_bias=False,
                      offset_scale=12.0), id='mostly-outside'),
]


@pytest.mark.parametrize('method', ['gather', 'pallas_interpret'])
@pytest.mark.parametrize('case', CASES)
def test_modulated_deform_conv_matches_jax(case, method):
    """Values and the gradients of x, offset, mask, weight and bias."""
    arrays, settings = _case(**case)
    _compare(_port_outputs(arrays, settings), _jax_outputs(arrays, settings, method))


@pytest.mark.parametrize('method', ['gather', 'pallas_interpret'])
@pytest.mark.parametrize('offsets', ['zero', 'whole', 'border'])
def test_position_gradient_at_whole_positions(offsets, method):
    """At whole-number positions (``conv_offset`` starts at zero) the offset
    gradient is the one-sided difference, not zero; on the border of
    (-1, H) x (-1, W) and beyond it is zero. Both as the JAX package has it."""
    arrays, settings = _case(seed=13, n=1, h=8, w=8, cin=4, cout=4, dg=1)
    if offsets == 'zero':
        arrays['offset'][:] = 0.
    elif offsets == 'whole':
        arrays['offset'] = np.round(arrays['offset'])
    else:   # every tap of output row 0 on y = -1 or y = H exactly, row 1 far outside
        arrays['offset'] = np.round(arrays['offset'])
        for k in range(9):
            arrays['offset'][0, 0, :, 2 * k] = -1. - (0 - 1 + k // 3)
            arrays['offset'][0, 7, :, 2 * k] = 8. - (7 - 1 + k // 3)
        arrays['offset'][0, 1] = 40.
    got = _port_outputs(arrays, settings)
    _compare(got, _jax_outputs(arrays, settings, method))
    if offsets == 'zero':
        assert np.abs(got['doffset']).max() > 1e-2
    if offsets == 'border':
        assert np.all(got['doffset'][0, 0, :, 0::2] == 0.)
        assert np.all(got['doffset'][0, 1] == 0.)
        assert np.all(got['out'][0, 1] == arrays['bias'])


def test_bfloat16_matches_pallas_interpret():
    """bfloat16 activations: the samples come back in bfloat16, blended in
    float32 and rounded once. XLA on the CPU cannot run the bfloat16 products
    of the JAX package's kernels, so its forward kernel runs in float32 on
    inputs that bfloat16 holds exactly, and the port's bfloat16 samples must
    be its values rounded (2**-8 relative, one bfloat16 ulp). The
    convolution's gradients are held against the port's float32 ones: summed
    in float32 and rounded once, they stay within 2e-2 of them."""
    arrays, settings = _case(seed=16, n=2, h=9, w=11, cin=8, cout=6, dg=2, offset_scale=2.0)
    for name in ('x', 'offset', 'mask', 'dout'):   # values bfloat16 holds exactly
        arrays[name] = np.asarray(jnp.asarray(arrays[name]).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
    n, h, w, c = arrays['x'].shape
    dg, cpg = 2, c // 2
    # the slabs and padded positions that modulated_deform_conv hands its kernel
    slabs = np.pad(arrays['x'].reshape(n, h, w, dg, cpg).transpose(0, 3, 1, 2, 4)
                   .reshape(n * dg, h, w, cpg), ((0, 0), (1, 1), (1, 1), (0, 0)))
    off = arrays['offset'].reshape(n, h, w, dg, 9, 2)
    taps = np.arange(9)
    py = np.arange(h).reshape(1, h, 1, 1, 1) - 1 + taps // 3 + off[..., 0] + 1.
    px = np.arange(w).reshape(1, 1, w, 1, 1) - 1 + taps % 3 + off[..., 1] + 1.
    pos = np.stack([py, px], -1).transpose(0, 3, 1, 2, 4, 5).reshape(n * dg, h * w, 18)
    want = jax.jit(lambda a, b: ref._sample_all_pallas(a, b, True))(
        jnp.asarray(slabs), jnp.asarray(pos.astype(np.float32)))
    want = np.asarray(want).reshape(n, dg, 9, cpg, h, w)
    geo = port.SampleGeometry(3, 3, 1, 1, 1, dg)
    got = port.deform_sample_forward(torch.from_numpy(_nchw(arrays['x'])).bfloat16(),
                                     torch.from_numpy(_nchw(arrays['offset'])), None, geo)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().reshape(n, dg, cpg, 9, h, w).transpose(0, 1, 3, 2, 4, 5)
    np.testing.assert_allclose(got, want, rtol=2**-8, atol=2**-8)

    low = _port_outputs(arrays, settings, dtype=torch.bfloat16)
    full = _port_outputs(arrays, settings)
    _compare(low, full, value_tol=2e-2, grad_tol=2e-2)


def test_output_has_the_input_type_with_float32_weights():
    x = torch.rand(1, 4, 6, 6).bfloat16()
    offset = torch.zeros(1, 18, 6, 6).bfloat16()
    out = port.modulated_deform_conv(x, offset, None, torch.rand(4, 4, 3, 3), torch.rand(4))
    assert out.dtype == torch.bfloat16


def test_zero_offsets_and_unit_mask_are_a_convolution():
    torch.manual_seed(0)
    x, w, b = torch.rand(2, 6, 7, 9), torch.rand(4, 3, 3, 3), torch.rand(4)
    offset = torch.zeros(2, 2 * 2 * 9, 7, 9)
    out = port.modulated_deform_conv(x, offset, torch.ones(2, 18, 7, 9), w, b, groups=2,
                                     deform_groups=2)
    want = torch.nn.functional.conv2d(x, w, b, padding=1, groups=2)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_wrong_shapes_raise():
    x = torch.rand(1, 4, 6, 6)
    with pytest.raises(ValueError, match='offset must be'):
        port.modulated_deform_conv(x, torch.zeros(1, 18, 5, 6), None, torch.rand(4, 4, 3, 3))
    with pytest.raises(ValueError, match='mask must be'):
        port.modulated_deform_conv(x, torch.zeros(1, 18, 6, 6), torch.zeros(1, 8, 6, 6),
                                   torch.rand(4, 4, 3, 3))
    with pytest.raises(ValueError, match='does not fit'):
        port.modulated_deform_conv(x, torch.zeros(1, 18, 6, 6), None, torch.rand(4, 3, 3, 3))


def test_pack_modules_load_the_jax_parameters():
    """``DCNv2Pack`` with converted parameters against the JAX module, every
    parameter non-zero (``conv_offset`` starts at zero and would hide the
    sampler)."""
    from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
    rng = np.random.RandomState(3)
    x = rng.rand(2, 8, 10, 8).astype(np.float32)
    feat = rng.rand(2, 8, 10, 8).astype(np.float32)
    module = ref.DCNv2Pack(8, 6, 3, padding=1, deformable_groups=2)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feat))['params']
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)), params)
    want = np.asarray(module.apply({'params': params}, jnp.asarray(x), jnp.asarray(feat)))
    net = port.DCNv2Pack(8, 6, 3, padding=1, deformable_groups=2)
    net.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.array, params)))
    got = net(torch.from_numpy(_nchw(x)), torch.from_numpy(_nchw(feat)))
    np.testing.assert_allclose(_nhwc(got.detach().numpy()), want, rtol=1e-5, atol=1e-5)


def test_offset_diagnostic_warns_only_when_asked(caplog):
    net = port.DCNv2Pack(4, 4, 3, padding=1, deformable_groups=1)
    torch.nn.init.constant_(net.conv_offset.bias, 60.)
    x = torch.rand(1, 4, 6, 6)
    logger = port.get_root_logger()
    logger.propagate = True
    try:
        with caplog.at_level('WARNING'):
            net(x, x)
            assert 'Offset abs mean' not in caplog.text
            net.log_offset = True
            net(x, x)
            assert 'Offset abs mean' in caplog.text
    finally:
        logger.propagate = False


# ------------------------------------------------------------------ flow_warp
def _warp_case(seed=0, n=2, h=16, w=24, c=8, mag=6.0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, h, w, c).astype(np.float32)
    flow = ((rs.rand(n, h, w, 2).astype(np.float32) * 2 - 1) * mag).round(3)
    flow[0, :2, :2] = 2.0    # whole positions
    flow[0, -1, -1] = 50.0   # far outside
    return x, flow


def _flow_as(flow, layout):
    """A numpy flow (N, H, W, 2) as a torch tensor: contiguous, or as
    BasicVSR++ and SpyNet hand it over, ``permute(0, 2, 3, 1)`` of a
    contiguous (N, 2, H, W) map."""
    if layout == 'permuted':
        nchw = np.ascontiguousarray(flow.transpose(0, 3, 1, 2))
        return torch.from_numpy(nchw).permute(0, 2, 3, 1)
    return torch.from_numpy(flow.copy())


@pytest.mark.parametrize('interpolation, padding_mode, layout',
                         [('bilinear', 'zeros', 'contiguous'), ('bilinear', 'border', 'contiguous'),
                          ('nearest', 'zeros', 'contiguous'), ('nearest', 'border', 'contiguous'),
                          ('bilinear', 'zeros', 'permuted'), ('bilinear', 'border', 'permuted')],
                         ids=['bilinear-zeros', 'bilinear-border', 'nearest-zeros',
                              'nearest-border', 'bilinear-zeros-permuted',
                              'bilinear-border-permuted'])
def test_flow_warp_matches_jax(interpolation, padding_mode, layout):
    """Values, and for the bilinear modes the gradients of the map and the
    flow, against the JAX ``flow_warp`` through its Pallas kernels; the flow
    contiguous or permuted from (N, 2, H, W), as BasicVSR++ passes it (the
    'zeros' mode reads it through its strides)."""
    x, flow = _warp_case(seed=1)
    weights = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)

    def run(xx, ff):
        out, vjp = jax.vjp(lambda a, b: ref_util.flow_warp(
            a, b, interpolation=interpolation, padding_mode=padding_mode), xx, ff)
        return (out,) + vjp(jnp.asarray(weights))

    with dispatch.force_interpret():
        want = [np.asarray(a) for a in jax.jit(run)(jnp.asarray(x), jnp.asarray(flow))]
    tx = torch.from_numpy(_nchw(x)).requires_grad_()
    tf = _flow_as(flow, layout).requires_grad_()
    out = port_util.flow_warp(tx, tf, interpolation=interpolation, padding_mode=padding_mode)
    np.testing.assert_allclose(_nhwc(out.detach().numpy()), want[0], rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    if interpolation == 'bilinear':
        out.backward(torch.from_numpy(_nchw(weights)))
        np.testing.assert_allclose(_nhwc(tx.grad.numpy()), want[1], rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(tf.grad.numpy(), want[2], rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize('layout', ['contiguous', 'permuted'])
def test_flow_offset_strides(layout):
    """The strides the sampler reads a flow through (``offset_layout``),
    applied by ``torch.as_strided`` (``offset_pairs``), give BasicSR's offset
    (N, 2, H, W) = (dy, dx): the flow's own values, and the offset that
    ``bilinear_warp`` builds from positions (h + dy) - h. On flows of
    multiples of 2**-10 under 64 on this grid both sums are exact, so the two
    are equal bit for bit."""
    flow = (np.random.RandomState(7).randint(-2**16, 2**16, (2, 16, 24, 2)) / 2**10).astype(
        np.float32)
    tf = _flow_as(flow, layout)
    pairs = port.offset_pairs(port.flow_operand(tf), port.FLOW_WARP)
    assert pairs.shape == (2, 2, 16, 24)
    dy_dx = np.ascontiguousarray(flow[..., ::-1].transpose(0, 3, 1, 2))
    assert torch.equal(pairs, torch.from_numpy(dy_dx))
    grid_y = torch.arange(16, dtype=torch.float32).view(1, 16, 1)
    grid_x = torch.arange(24, dtype=torch.float32).view(1, 1, 24)
    py, px = grid_y + tf[..., 1], grid_x + tf[..., 0]
    assert torch.equal(pairs, torch.stack([py - grid_y, px - grid_x], dim=1))
    layout_ = port.offset_layout(port.flow_operand(tf), port.FLOW_WARP)
    assert layout_.pair == -layout_.start and layout_.tap == 0
    assert layout_.pixel == (1 if layout == 'permuted' else 2)


@pytest.mark.parametrize('op', ['deform_sample_fwd', 'deform_sample_bwd'])
def test_binding_matches_the_c_signature(monkeypatch, op):
    """The sampler's ctypes types are its kernels' C parameters, one for one."""
    from test_torch_conv3x3 import bound_argtypes, c_signature
    assert bound_argtypes(monkeypatch, port, op, op) == c_signature(op)


def test_flow_warp_rejects_other_modes():
    x, flow = torch.rand(1, 2, 4, 4), torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        port_util.flow_warp(x, flow, padding_mode='reflection')
    with pytest.raises(ValueError):
        port_util.flow_warp(x, flow, interpolation='bicubic')


def test_backward_launch_is_skipped_for_inputs_without_gradient(monkeypatch):
    """The backward asks the sampler only for the gradients autograd needs."""
    asked = []
    real = port.deform_sample_backward

    def spy(*args, **kwargs):
        asked.append((kwargs['need_dx'], kwargs['need_doffset']))
        return real(*args, **kwargs)

    monkeypatch.setattr(port, 'deform_sample_backward', spy)
    x = torch.rand(1, 2, 5, 5)
    py = torch.rand(1, 5, 5).requires_grad_()
    port.bilinear_warp(x, py, torch.rand(1, 5, 5)).sum().backward()
    assert asked == [(False, True)]


@pytest.mark.parametrize('size_type, sizes, interpolation', [
    ('ratio', (0.5, 0.5), 'bilinear'), ('ratio', (2, 1.5), 'bilinear'),
    ('shape', (10, 18), 'bilinear'), ('shape', (32, 48), 'nearest')])
def test_resize_flow_matches_jax(size_type, sizes, interpolation):
    """The resized flow's values scale with the new pixel size; 1e-5 absolute
    on flows of a few pixels."""
    _, flow = _warp_case(seed=2)
    want = ref_util.resize_flow(jnp.asarray(flow), size_type, sizes, interpolation)
    got = port_util.resize_flow(torch.from_numpy(flow), size_type, sizes, interpolation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='ratio or shape'):
        port_util.resize_flow(torch.from_numpy(flow), 'scale', sizes)


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('out_size', [(32, 48), (9, 13), (16, 24)])
def test_resize_bilinear_matches_jax(out_size, align_corners):
    x, _ = _warp_case(seed=3)
    want = ref_util.resize_bilinear(jnp.asarray(x), *out_size, align_corners=align_corners)
    got = port_util.resize_bilinear(torch.from_numpy(_nchw(x)), *out_size,
                                    align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_residual_block_and_make_layer():
    """``ResidualBlockNoBN`` against the JAX block with carried weights, and
    BasicSR's initialisation: residual convolutions at a tenth of the
    Kaiming scale, zero biases."""
    from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
    rng = np.random.RandomState(5)
    x = rng.rand(2, 6, 7, 8).astype(np.float32)
    block = ref_util.ResidualBlockNoBN(8, res_scale=0.5)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)), params)
    want = np.asarray(block.apply({'params': params}, jnp.asarray(x)))
    net = port_util.ResidualBlockNoBN(8, res_scale=0.5)
    net.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.array, params)))
    np.testing.assert_allclose(_nhwc(net(torch.from_numpy(_nchw(x))).detach().numpy()), want,
                               rtol=1e-5, atol=1e-5)
    torch.manual_seed(0)
    layers = port_util.make_layer(port_util.ResidualBlockNoBN, 3, num_feat=64)
    assert len(layers) == 3
    std = float(layers[0].conv1.weight.detach().std())
    assert 0.8 < std / (0.1 * (2 / (64 * 9))**0.5) < 1.2
    assert not layers[2].conv2.bias.any()
