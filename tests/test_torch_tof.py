"""The port's TOFlow (basicsr4rs_torch/archs/tof_arch.py) against the JAX
package, float32 on the CPU, same numpy inputs, the JAX module's parameters
and BatchNorm statistics (every leaf random) carried across by
``utils.jax_convert``, under ``dispatch.force_interpret()`` (its warps on
the Pallas kernel's own math): in eval mode (running statistics, the support
frames folded into the batch) and in train mode (per-frame batch statistics,
and the running statistics they leave). Outputs within 1e-4 of their largest
entry, every parameter's gradient of a mean-square loss within 1e-3 of the
largest gradient entry, running statistics within 1e-5. The helpers serve
``test_torch_duf.py`` too."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import duf_arch as port_duf
from basicsr4rs_torch.archs import tof_arch as port_tof
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import duf_arch as ref_duf
from basicsr4rs_tpu.archs import tof_arch as ref_tof
from basicsr4rs_tpu.ops import dispatch
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_basicvsr import few_threads  # noqa: F401 (autouse fixture)
from test_torch_basicvsrpp import from_jax, smooth_clip, to_jax
from test_torch_swinir import _randomize

CASES = {   # name: (JAX class, port class, config, LQ size, train mode, Pallas in interpret mode)
    'TOFlow-eval': (ref_tof.TOFlow, port_tof.TOFlow, dict(adapt_official_weights=True),
                    (32, 48), False, True),
    'TOFlow-train': (ref_tof.TOFlow, port_tof.TOFlow, dict(), (64, 64), True, True),
    'DUF-16': (ref_duf.DUF, port_duf.DUF, dict(num_layer=16), (8, 12), False, False),
    'DUF-52': (ref_duf.DUF, port_duf.DUF, dict(num_layer=52, adapt_official_weights=True),
               (8, 8), False, False),
}
HERE = ('TOFlow-eval', 'TOFlow-train')   # the cases of this file; test_torch_duf.py has the rest


def random_variables(net, seed, x):
    """Random params and BatchNorm statistics (variances in [0.5, 1.5])."""
    shapes = jax.eval_shape(lambda a: net.init(jax.random.PRNGKey(0), a), x)
    rng = np.random.RandomState(seed)
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                               shapes['params']), rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: ((rng.rand(*s.shape) + 0.5) if p[-1].key == 'var'
                      else 0.1 * rng.randn(*s.shape)).astype(np.float32), shapes['batch_stats'])
    return params, stats


def jax_run(name):
    """(clip, target, params, stats, output, loss, gradients as a torch
    state_dict, the running statistics after the pass as one)."""
    jax_cls, port_cls, cfg, size, train, interpret = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = smooth_clip(rng, 2, 7, *size)
    jnet = jax_cls(**cfg)
    params, stats = random_variables(jnet, 1, to_jax(x))
    out_shape = jax.eval_shape(lambda: jnet.apply({'params': params, 'batch_stats': stats},
                                                  to_jax(x)))
    target = from_jax(rng.rand(*out_shape.shape).astype(np.float32))

    def loss_and_out(p):
        out, new = jnet.apply({'params': p, 'batch_stats': stats}, to_jax(x), train=train,
                              mutable=['batch_stats'])
        return jnp.mean((out - to_jax(target))**2), (out, new['batch_stats'])

    with dispatch.force_interpret() if interpret else contextlib.nullcontext():
        (loss, (out, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss_and_out, has_aux=True))(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.array, jax.device_get(t))   # noqa: E731
    grads = jax_params_to_state_dict(np_tree(grads), port_cls.JAX_KEY_RULES)
    after = jax_params_to_state_dict(np_tree(params), port_cls.JAX_KEY_RULES, np_tree(new_stats))
    return x, target, params, stats, from_jax(out), float(loss), grads, after


@pytest.fixture(scope='module')
def runs():
    return {name: jax_run(name) for name in HERE}


def port_network(name, params, stats):
    _, port_cls, cfg = CASES[name][:3]
    net = port_cls(**cfg)
    state = jax_params_to_state_dict(params, port_cls.JAX_KEY_RULES, stats)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    return net


def check_forward_and_gradients(name, run):
    x, target, params, stats, want, want_loss, want_grads, after = run
    train = CASES[name][4]
    net = port_network(name, params, stats).train(train)
    out = net(torch.from_numpy(x))
    assert out.shape == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    loss = ((out - torch.from_numpy(target))**2).mean()
    loss.backward()
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == want_grads.keys()
    floor = 1e-3 * max(float(g.abs().max()) for g in want_grads.values())
    for key, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[key].numpy(), rtol=0, atol=floor,
                                   err_msg=key)
    for key, value in net.state_dict().items():   # the running statistics the pass left
        if 'running' in key:
            np.testing.assert_allclose(value.numpy(), after[key].numpy(), rtol=0, atol=1e-5,
                                       err_msg=key)
    if train:   # a train-mode pass moves them (an eval-mode one leaves them: `after`)
        first = 'spynet.basic_module.0.basic_module.1.running_mean'
        assert not np.allclose(net.state_dict()[first].numpy(),
                               np.asarray(stats['spynet']['basic_module_0']['basic_module_1']
                                          ['mean']))


@pytest.mark.parametrize('name', HERE)
def test_forward_and_gradients_match_jax(name, runs):
    check_forward_and_gradients(name, runs[name])


def check_round_trip(name, run):
    """The JAX params into the port (strict, with the statistics), and the
    port's parameters back through the JAX package's converter with the JAX
    class's rules: the same tree."""
    jax_cls = CASES[name][0]
    _, _, params, stats = run[:4]
    net = port_network(name, params, stats)
    back = convert_torch_state_dict({k: v.detach().numpy() for k, v in net.named_parameters()},
                                    rules=jax_cls.TORCH_KEY_RULES)
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_weights_round_trip_through_both_converters(runs):
    check_round_trip('TOFlow-eval', runs['TOFlow-eval'])


def test_tof_train_mode_aligns_frame_by_frame(monkeypatch):
    """Train mode calls the flow network once a support frame (BatchNorm
    batches of one frame each), eval mode once for all six; the warps are
    the sampler's one-tap calls: 4 levels and the frame's warp each time."""
    from basicsr4rs_torch.ops import dcn
    calls = []
    real = dcn.deform_sample_forward

    def fwd(x, offset, mask, geo):
        calls.append(x.shape[0])
        return real(x, offset, mask, geo)

    monkeypatch.setattr(dcn, 'deform_sample_forward', fwd)
    net = port_tof.TOFlow()
    clip = torch.rand(2, 7, 3, 32, 32)
    with torch.no_grad():
        net.train()(clip)
        assert calls == [2] * 30
        calls.clear()
        net.eval()(clip)
        assert calls == [12] * 5


def test_a_basicsr_checkpoint_with_the_normalisation_loads(tmp_path):
    """BasicSR's TOFlow stores ``mean`` and ``std``, which the port keeps
    outside its ``state_dict``: ``load_network`` drops them, strict."""
    from basicsr4rs_torch.models.base_model import BaseModel
    net = port_tof.TOFlow()
    state = dict(net.state_dict(), mean=net.mean.clone(), std=net.std.clone())
    torch.save({'params': state}, tmp_path / 'tof.pth')
    other = port_tof.TOFlow()
    BaseModel({'is_train': False, 'num_gpu': 0}).load_network(other, str(tmp_path / 'tof.pth'))
    for key, value in net.state_dict().items():
        assert torch.equal(other.state_dict()[key], value), key
