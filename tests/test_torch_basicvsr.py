"""The port's BasicVSR, IconVSR and EDVR feature extractor
(basicsr4rs_torch/archs/basicvsr_arch.py) against the JAX package, float32
on the CPU, same numpy inputs, the JAX modules' parameters (every leaf
random) carried across by ``utils.jax_convert``. The JAX networks scan a step
over the frames. Each case is compiled once (a jitted value and gradient of
a mean-square loss) in a module fixture. BasicVSR runs under
``dispatch.force_interpret()``: its warps run the Pallas kernels' own math,
forward and backward. IconVSR's value and gradient run the JAX package's
plain deformable route (its Pallas backward in interpret mode compiles for
over a minute on this host); ``test_torch_iconvsr.py`` holds its forward
under ``force_interpret()``. Outputs within 1e-4 of their largest entry;
every parameter's gradient within 1e-3 of the largest gradient entry of the
network."""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import basicvsr_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import basicvsr_arch as ref
from basicsr4rs_tpu.ops import dispatch
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_basicvsrpp import from_jax, random_params, smooth_clip, to_jax

SMALL = dict(num_feat=8, num_block=1)
CASES = {   # name: (JAX class, port class, config, frames, LQ size, Pallas in interpret mode)
    'BasicVSR': (ref.BasicVSR, port.BasicVSR, SMALL, 3, (64, 64), True),
    'IconVSR-tp2': (ref.IconVSR, port.IconVSR, dict(SMALL, keyframe_stride=2,
                                                    temporal_padding=2), 5, (64, 66), False),
    'IconVSR-tp3': (ref.IconVSR, port.IconVSR, dict(SMALL, keyframe_stride=5,
                                                    temporal_padding=3), 7, (64, 64), False),
}
HERE = ('BasicVSR', 'IconVSR-tp3')   # the cases of this file; IconVSR-tp2's file has the other


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def case_inputs(name):
    """(clip, target, JAX params) of one case."""
    jax_cls, _, cfg, frames, size, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = smooth_clip(rng, 1, frames, *size)
    target = rng.rand(1, frames, 3, 4 * size[0], 4 * size[1]).astype(np.float32)
    return x, target, random_params(jax_cls(**cfg), 1, to_jax(x))


def jax_run(name, x, target, params):
    """(JAX output, loss, parameter gradients as a torch state_dict) of one
    case."""
    jax_cls, port_cls, cfg, _, _, interpret = CASES[name]
    jnet = jax_cls(**cfg)

    def loss_and_out(p):
        out = jnet.apply({'params': p}, to_jax(x))
        return jnp.mean((out - to_jax(target))**2), out

    with dispatch.force_interpret() if interpret else contextlib.nullcontext():
        (loss, out), grads = jax.jit(jax.value_and_grad(loss_and_out, has_aux=True))(params)
    grads = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, jax.device_get(grads)),
                                     port_cls.JAX_KEY_RULES)
    return from_jax(out), float(loss), grads


@pytest.fixture(scope='module')
def run(request):
    """One case's inputs, and its ``jax_run`` started in a thread, so that
    the port's forward and backward run while JAX traces and compiles; once
    a module (its tests of the case share it; the two cases' runs fall to
    their own tests)."""
    name = request.param
    inputs = case_inputs(name)
    with ThreadPoolExecutor(1) as pool:
        yield name, inputs, pool.submit(jax_run, name, *inputs)


def port_network(name, params):
    _, port_cls, cfg = CASES[name][:3]
    net = port_cls(**cfg)
    state = jax_params_to_state_dict(params, port_cls.JAX_KEY_RULES)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    return net


def check_forward_and_gradients(name, inputs, jax_result):
    x, target, params = inputs
    net = port_network(name, params).train()
    out = net(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(target))**2).mean()
    loss.backward()
    want, want_loss, want_grads = jax_result.result()
    assert out.shape == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want_grads.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want_grads.values())
    for key, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[key].numpy(), rtol=0, atol=floor,
                                   err_msg=key)
    for key in ('spynet.basic_module.0.basic_module.0.weight', 'forward_trunk.main.0.weight'):
        assert float(got[key].abs().max()) > 0, key
    if name.startswith('IconVSR'):
        for key in ('edvr.pcd_align.dcn_pack.l3.conv_offset.weight', 'backward_fusion.weight'):
            assert float(got[key].abs().max()) > 0, key


@pytest.mark.parametrize('run', HERE, indirect=True)
def test_forward_and_gradients_match_jax(run):
    check_forward_and_gradients(*run)


def check_round_trip(name, params):
    """A JAX tree into the port (strict), and the port's ``state_dict`` back
    through the JAX package's converter with the JAX class's rules: the same
    tree, path for path."""
    jax_cls = CASES[name][0]
    net = port_network(name, params)
    back = convert_torch_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                    rules=getattr(jax_cls, 'TORCH_KEY_RULES', None))
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize('run', HERE, indirect=True)
def test_weights_round_trip_through_both_converters(run):
    name, (_, _, params), _ = run
    check_round_trip(name, params)


@pytest.mark.parametrize('tp, frames', [(2, 4), (3, 6)])
def test_iconvsr_raises_on_a_short_clip(tp, frames):
    """BasicSR's frame indices need 2 * temporal_padding + 1 frames (the JAX
    package clamps them)."""
    net = port.IconVSR(**SMALL, temporal_padding=tp)
    with pytest.raises(ValueError, match=f'at least {2 * tp + 1} frames'):
        net(torch.rand(1, frames, 3, 64, 64))


def test_iconvsr_keyframes():
    assert port.keyframes(14, 5) == [0, 5, 10, 13]
    assert port.keyframes(11, 5) == [0, 5, 10]
    with pytest.raises(ValueError, match='temporal_padding'):
        port.IconVSR(**SMALL, temporal_padding=4)


def test_sampler_calls_of_a_training_step(monkeypatch):
    """What a forward and backward of an IconVSR clip asks of the sampler:
    one-tap calls for SpyNet's six levels and a feature warp a step but each
    branch's first; four nine-tap calls an extractor group (PCD's three
    levels and the cascade); one backward call for each but SpyNet's first
    level, whose inputs need no gradient."""
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
    t = 5
    net = port.IconVSR(**SMALL, keyframe_stride=2)
    net(torch.rand(1, t, 3, 64, 64)).mean().backward()
    groups = len(port.keyframe_groups(1, t, 64, 64, 2, 2))
    assert calls['fwd'].count(9) == calls['bwd'].count(9) == 4 * groups
    warps = 6 + 2 * (t - 1)
    assert calls['fwd'].count(1) == warps and calls['bwd'].count(1) == warps - 1
