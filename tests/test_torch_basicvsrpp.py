"""The port's SpyNet and BasicVSR++ (basicsr4rs_torch/archs/spynet_arch.py,
basicvsrpp_arch.py) against the JAX package, float32 on the CPU, same numpy
inputs, the JAX modules' parameters carried across by ``utils.jax_convert``
with every leaf random (the last offset convolution starts at zero and would
hide the sampler). 64x64 is BasicVSR++'s smallest input. The JAX network
scans a masked step over the frames where the port loops with ``if i > 0``;
under ``dispatch.force_interpret()`` its warps and deformable convolutions
run on the Pallas kernels. Outputs within 1e-4 absolute; SpyNet's input
gradients within 5e-3 and the whole network's parameter gradients within
1e-2 of the largest entry of each tensor (float32 sums in another order
through a recurrence of some 60 convolutions a frame: SpyNet's gradients,
which pass through every warp and alignment after it, are the noisiest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import basicvsrpp_arch as port
from basicsr4rs_torch.archs import spynet_arch as port_spynet
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import basicvsrpp_arch as ref
from basicsr4rs_tpu.archs import spynet_arch as ref_spynet
from basicsr4rs_tpu.ops import dispatch

from test_torch_swinir import _randomize
from test_torch_unet import assert_close_rel

SMALL = dict(mid_channels=8, num_blocks=1)
RULES = port.BasicVSRPlusPlus.JAX_KEY_RULES


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def to_jax(x):
    """(..., C, H, W) numpy -> (..., H, W, C) jax."""
    return jnp.asarray(np.moveaxis(x, -3, -1))


def from_jax(y):
    return np.moveaxis(np.asarray(y), -1, -3)


def random_params(net, seed, *args):
    shapes = jax.eval_shape(lambda *a: net.init(jax.random.PRNGKey(0), *a), *args)['params']
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return _randomize(tree, np.random.RandomState(seed))


def smooth_clip(rng, n, t, h, w):
    """Frames that are shifted copies of one smooth image, so that the flows
    are a few pixels and not noise."""
    base = rng.rand(n, 3, h // 8 + 4, w // 8 + 4).astype(np.float32)
    big = torch.nn.functional.interpolate(torch.from_numpy(base), scale_factor=8, mode='bicubic',
                                          align_corners=False).numpy()
    frames = [big[:, :, 8 + i:8 + i + h, 8 + 2 * i:8 + 2 * i + w] for i in range(t)]
    return np.clip(np.stack(frames, axis=1), 0, 1).astype(np.float32)


def port_network(cfg, params):
    net = port.BasicVSRPlusPlus(**cfg)
    state = jax_params_to_state_dict(params, RULES)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    return net


@pytest.mark.parametrize('size', [(64, 64), (48, 72)], ids=['64x64', '48x72-resized'])
@pytest.mark.parametrize('interpret', [False, True], ids=['gather', 'pallas-interpret'])
def test_spynet_matches_jax(size, interpret):
    """Values and the gradients of both images (the flow's gradient passes
    through five ``border`` warps)."""
    rng = np.random.RandomState(0)
    clip = smooth_clip(rng, 2, 2, *size)
    a, b = clip[:, 0], clip[:, 1]
    weights = rng.randn(2, 2, *size).astype(np.float32)
    jnet = ref_spynet.SpyNet()
    params = random_params(jnet, 1, to_jax(a), to_jax(b))

    def run(p, x, y):
        out, vjp = jax.vjp(lambda u, v: jnet.apply({'params': p}, u, v), x, y)
        return (out,) + vjp(to_jax(weights))

    if interpret:
        with dispatch.force_interpret():
            want = jax.jit(run)(params, to_jax(a), to_jax(b))
    else:
        want = jax.jit(run)(params, to_jax(a), to_jax(b))
    want = [from_jax(v) for v in want]
    net = port_spynet.SpyNet()
    net.load_state_dict(jax_params_to_state_dict(params, net.JAX_KEY_RULES))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    out = net(ta, tb)
    out.backward(torch.from_numpy(weights))
    assert out.shape == (2, 2, *size)
    np.testing.assert_allclose(out.detach().numpy(), want[0], rtol=1e-4, atol=1e-4)
    assert_close_rel(ta.grad.numpy(), want[1], 5e-3, 'd ref')
    assert_close_rel(tb.grad.numpy(), want[2], 5e-3, 'd supp')


def test_second_order_alignment_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.rand(1, 16, 12, 14).astype(np.float32)
    extra = rng.rand(1, 24, 12, 14).astype(np.float32)
    flow_1 = (rng.randn(1, 2, 12, 14) * 2).astype(np.float32)
    flow_2 = (rng.randn(1, 2, 12, 14) * 2).astype(np.float32)
    jnet = ref.SecondOrderDeformableAlignment(16, 8, 3, padding=1, deformable_groups=4,
                                              max_residue_magnitude=5.)
    args = [to_jax(v) for v in (x, extra, flow_1, flow_2)]
    params = random_params(jnet, 3, *args)
    want = from_jax(jax.jit(lambda p, *a: jnet.apply({'params': p}, *a))(params, *args))
    net = port.SecondOrderDeformableAlignment(16, 8, 3, padding=1, deformable_groups=4,
                                              max_residue_magnitude=5.)
    net.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        got = net(*[torch.from_numpy(v) for v in (x, extra, flow_1, flow_2)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cfg, frames, size', [
    (dict(), 4, (64, 64)), (dict(), 1, (64, 64)), (dict(is_low_res_input=False), 3, (256, 256)),
], ids=['4-frames', '1-frame', 'high-res-input'])
def test_basicvsrpp_forward_matches_jax(cfg, frames, size):
    cfg = dict(SMALL, **cfg)
    x = smooth_clip(np.random.RandomState(4), 1, frames, *size)
    jnet = ref.BasicVSRPlusPlus(**cfg)
    params = random_params(jnet, 5, to_jax(x))
    want = from_jax(jax.jit(lambda p, a: jnet.apply({'params': p}, a))(params, to_jax(x)))
    net = port_network(cfg, params).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    scale = 4 if cfg.get('is_low_res_input', True) else 1
    assert got.shape == (1, frames, 3, scale * size[0], scale * size[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_basicvsrpp_gradients_match_jax_kernels():
    """Every parameter's gradient of a mean-square loss on a 3-frame clip:
    through SpyNet, the flow warps and the deformable alignments of all four
    branches, the JAX network on its Pallas kernels, forward and backward."""
    rng = np.random.RandomState(6)
    x = smooth_clip(rng, 1, 3, 64, 64)
    target = rng.rand(1, 3, 3, 256, 256).astype(np.float32)
    jnet = ref.BasicVSRPlusPlus(**SMALL)
    params = random_params(jnet, 7, to_jax(x))

    def jax_loss(p):
        return jnp.mean((jnet.apply({'params': p}, to_jax(x)) - to_jax(target))**2)

    with dispatch.force_interpret():
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, jax.device_get(want)),
                                    RULES)
    net = port_network(SMALL, params).train()
    loss = ((net(torch.from_numpy(x)) - torch.from_numpy(target))**2).mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for key, grad in got.items():
        assert_close_rel(grad.numpy(), want[key].numpy(), 1e-2, key, floor)
    for key in ('spynet.basic_module.0.basic_module.0.weight',
                'deform_align.forward_2.conv_offset.6.weight'):
        assert float(got[key].abs().max()) > 0, key


def test_basicvsrpp_checks_the_input_size():
    with pytest.raises(ValueError, match='at least 64'):
        port.BasicVSRPlusPlus(**SMALL)(torch.zeros(1, 2, 3, 48, 64))


def test_sampler_calls_of_a_training_step(monkeypatch):
    """What a forward and backward of a T-frame clip asks of the sampler:
    4 (T - 1) nine-tap calls and 6 + 4 (T - 1) + 8 (T - 2) one-tap calls
    forward (SpyNet's six levels, a feature warp a step, a flow and a feature
    warp from the third step on); one backward call for each but SpyNet's
    first level, whose inputs need no gradient."""
    from basicsr4rs_torch.ops import dcn
    calls = {'fwd': [], 'bwd': []}
    real_fwd, real_bwd = dcn.deform_sample_forward, dcn.deform_sample_backward

    def fwd(x, offset, mask, geo):
        calls['fwd'].append(geo.kh * geo.kw)
        return real_fwd(x, offset, mask, geo)

    def bwd(x, offset, mask, dcol, geo, **kwargs):
        calls['bwd'].append(geo.kh * geo.kw)
        return real_bwd(x, offset, mask, dcol, geo, **kwargs)

    monkeypatch.setattr(dcn, 'deform_sample_forward', fwd)
    monkeypatch.setattr(dcn, 'deform_sample_backward', bwd)
    t = 4
    net = port.BasicVSRPlusPlus(**SMALL)
    net(torch.rand(1, t, 3, 64, 64)).mean().backward()
    assert calls['fwd'].count(9) == calls['bwd'].count(9) == 4 * (t - 1)
    warps = 6 + 4 * (t - 1) + 8 * (t - 2)
    assert calls['fwd'].count(1) == warps and calls['bwd'].count(1) == warps - 1


def test_port_state_dict_loads_in_the_jax_package():
    """BasicSR's keys through the JAX package's own converter and
    ``BasicVSRPlusPlus.TORCH_KEY_RULES`` give the JAX tree back."""
    from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict
    x = smooth_clip(np.random.RandomState(8), 1, 2, 64, 64)
    jnet = ref.BasicVSRPlusPlus(**SMALL)
    params = random_params(jnet, 9, to_jax(x))
    net = port_network(SMALL, params)
    back = convert_torch_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                    rules=ref.BasicVSRPlusPlus.TORCH_KEY_RULES)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
