"""The port's EDVR (basicsr4rs_torch/archs/edvr_arch.py) against the JAX
package, float32 on the CPU, same numpy inputs, the JAX module's parameters
carried across by ``utils.jax_convert`` with every leaf random
(``conv_offset`` starts at zero and would hide the sampler). The JAX network
runs its deformable convolutions on the gather path and, under
``dispatch.force_interpret()``, on its Pallas kernels in interpret mode.
Outputs within 1e-4 absolute (values of order 1, float32 sums in another
order through some 40 convolutions); gradients within 5e-3 of the largest
entry of each tensor: run in float64, the port's network shows both
packages' float32 gradients 1e-3 to 2e-3 from the exact ones at these random
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import edvr_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import edvr_arch as ref
from basicsr4rs_tpu.ops import dispatch

from test_torch_swinir import _randomize
from test_torch_unet import assert_close_rel

SMALL = dict(num_feat=16, num_frame=3, deformable_groups=2, num_extract_block=1,
             num_reconstruct_block=2)
RULES = port.EDVR.JAX_KEY_RULES


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def to_jax(x):
    """(B, T, C, H, W) numpy -> (B, T, H, W, C) jax."""
    return jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))


def from_jax(y):
    """(B, H, W, C) jax -> (B, C, H, W) numpy."""
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def jax_network(cfg, x, seed):
    net = ref.EDVR(**cfg)
    shapes = jax.eval_shape(lambda a: net.init(jax.random.PRNGKey(0), a), to_jax(x))['params']
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return net, _randomize(tree, np.random.RandomState(seed))


def port_network(cfg, params):
    net = port.EDVR(**cfg)
    state = jax_params_to_state_dict(params, RULES)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    return net


@pytest.mark.parametrize('extra, size', [
    (dict(), (16, 24)),
    (dict(with_tsa=False), (16, 16)),
    (dict(center_frame_idx=0), (16, 16)),
    (dict(with_predeblur=True), (16, 16)),
    (dict(with_predeblur=True, hr_in=True), (32, 32)),
], ids=['tsa', 'no-tsa', 'center0', 'predeblur', 'predeblur-hr'])
def test_edvr_forward_matches_jax(extra, size):
    cfg = dict(SMALL, **extra)
    x = np.random.RandomState(0).rand(2, 3, 3, *size).astype(np.float32)
    jnet, params = jax_network(cfg, x, seed=1)
    want = from_jax(jax.jit(lambda p, a: jnet.apply({'params': p}, a))(params, to_jax(x)))
    net = port_network(cfg, params).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    scale = 1 if cfg.get('hr_in') else 4
    assert got.shape == (2, 3, scale * size[0], scale * size[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_edvr_forward_matches_jax_on_its_pallas_kernels():
    x = np.random.RandomState(2).rand(1, 3, 3, 16, 16).astype(np.float32)
    jnet, params = jax_network(SMALL, x, seed=3)
    with dispatch.force_interpret():
        want = from_jax(jax.jit(lambda p, a: jnet.apply({'params': p}, a))(params, to_jax(x)))
    with torch.no_grad():
        got = port_network(SMALL, params).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('interpret', [False, True], ids=['gather', 'pallas-interpret'])
def test_edvr_gradients_match_jax(interpret):
    """Every parameter's gradient of a mean-square loss (smooth: a
    Charbonnier loss's gradient amplifies float32 noise where the error is
    near zero): through four deformable convolutions, whose offsets' and
    masks' gradients reach ``conv_offset`` and the convolutions before it."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 3, 16, 16).astype(np.float32)
    target = rng.rand(2, 3, 64, 64).astype(np.float32)
    jnet, params = jax_network(SMALL, x, seed=5)

    def jax_loss(p):
        out = jnet.apply({'params': p}, to_jax(x))
        diff = out - jnp.asarray(np.transpose(target, (0, 2, 3, 1)))
        return jnp.mean(diff**2)

    if interpret:
        with dispatch.force_interpret():
            want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    else:
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, jax.device_get(want)),
                                    RULES)
    net = port_network(SMALL, params).train()
    out = net(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(target))**2).mean()
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for key, grad in got.items():
        assert_close_rel(grad.numpy(), want[key].numpy(), 5e-3, key, floor)
    assert float(got['pcd_align.dcn_pack.l3.conv_offset.weight'].abs().max()) > 0


def test_edvr_checks_the_input_size():
    net = port.EDVR(**SMALL)
    with pytest.raises(ValueError, match='multiple of 4'):
        net(torch.zeros(1, 3, 3, 18, 16))


def test_port_state_dict_loads_in_the_jax_package():
    """The port's ``state_dict`` (BasicSR's keys) through the JAX package's
    own converter and ``EDVR.TORCH_KEY_RULES`` gives the same network."""
    from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict
    x = np.random.RandomState(6).rand(1, 3, 3, 16, 16).astype(np.float32)
    jnet, params = jax_network(SMALL, x, seed=7)
    net = port_network(SMALL, params).eval()
    back = convert_torch_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                    rules=ref.EDVR.TORCH_KEY_RULES)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
