"""The port's StyleGAN2 slice against the JAX package's, on the CPU:
``upfirdn2d`` and ``fused_leaky_relu`` (basicsr4rs_torch/ops/), the three
GAN regularisers (losses/gan_loss.py), both generators and the
discriminator (archs/stylegan2_arch.py, stylegan2_bilinear_arch.py), four
``StyleGAN2Model`` steps (models/stylegan2_model.py) and ``FFHQDataset``
(data/ffhq_dataset.py). The JAX networks' parameters go to the port
through ``jax_convert`` and the architectures' ``JAX_KEY_RULES``, at small
widths (``out_size`` 16 or 32, ``narrow`` 0.25, 8 style features, 2 MLP
layers), every parameter drawn non-zero (the noise weights start at zero).

Tolerances, float32: upfirdn2d 1e-6 absolute on inputs in [0, 1); the
networks' outputs 1e-5 of their largest magnitude; the regularisers'
values and gradients 1e-5 relative; the model's logged values 1e-4
relative (1e-6 absolute) and its parameters after four steps within 1e-3
of the largest change of each tensor, plus 1e-6 of its scale (the
regularisers' second-order gradients through convolutions, summed in
another order). Save and resume: equal to the uninterrupted run.
"""

import copy
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from basicsr4rs_torch.archs.stylegan2_arch import StyleGAN2Discriminator, StyleGAN2Generator
from basicsr4rs_torch.archs.stylegan2_bilinear_arch import StyleGAN2GeneratorBilinear
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.losses import gan_loss as port_gan_loss
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.ops.fused_act import fused_leaky_relu
from basicsr4rs_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import stylegan2_arch as jax_arch
from basicsr4rs_tpu.archs import stylegan2_bilinear_arch as jax_bilinear
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.losses import gan_loss as jax_gan_loss
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import stylegan2_model as jax_stylegan2_model
from basicsr4rs_tpu.parallel import mesh as jax_mesh
from basicsr4rs_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from basicsr4rs_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d

from test_torch_resshift import _shapes_only

G_KW = dict(out_size=32, num_style_feat=8, num_mlp=2, channel_multiplier=1, narrow=0.25)
NET_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2), order="C"))


def nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def randomized(params, seed):
    """Every leaf redrawn (the noise weights and biases start at zero):
    N(0, 1) for the weights, which the layers scale at run time (the style
    MLP's by its lr_mul of 0.01, so theirs are drawn 100 times larger), and
    N(0, 0.3^2) for biases and noise weights."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        names = [getattr(p, 'key', '') for p in path]
        scale = 1. if len(a.shape) >= 4 or names[-1] == 'kernel' else 0.3
        if names[-1] == 'kernel' and any(n.startswith('style_mlp') for n in names):
            scale = 100.
        return (rng.randn(*a.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


def port_net(cls, params, **kwargs):
    net = cls(**kwargs)
    missing, unexpected = net.load_state_dict(
        jax_params_to_state_dict(params, getattr(cls, 'JAX_KEY_RULES', None)), strict=False)
    # the stored noise maps live outside the JAX params (zeros in both)
    assert not unexpected and all(k.startswith('noises.') for k in missing), (missing, unexpected)
    return net


def assert_close(got, want, tol=NET_TOL, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f'{what}: {err:.3e}'


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize('up, down, pad', [
    (1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (2, 2)), (2, 1, (1, 2, 2, 1)),
    (1, 1, (-1, -1)), (2, 1, (-2, 3)), (1, 2, (2, -1, -1, 2)), (4, 1, (1, 1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    """Up, down and pad cases; negative pads crop."""
    x = np.random.RandomState(0).rand(2, 11, 13, 4).astype(np.float32)
    k = make_resample_kernel([1, 3, 3, 1]).numpy()
    want = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    got = upfirdn2d(nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


def test_fused_leaky_relu_matches_jax():
    rng = np.random.RandomState(0)
    x, b = rng.randn(2, 5, 3, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    want = jax_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(nhwc(fused_leaky_relu(nchw(x), torch.from_numpy(b))),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- regularisers
def _conv_d(w, x, lib):
    """A small discriminator of one conv weight w (HWIO) in either library."""
    if lib == 'jax':
        y = jax.lax.conv_general_dilated(x, w, (1, 1), 'SAME',
                                         dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        return jnp.tanh(y).mean(axis=(1, 2, 3)) * 3.
    y = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
    return torch.tanh(y).mean(dim=(1, 2, 3)) * 3.


@pytest.mark.parametrize('which', ['r1', 'gradient_penalty', 'gradient_penalty_weighted'])
def test_discriminator_penalties_match_jax(which):
    """Value and gradient with respect to the discriminator's weight."""
    rng = np.random.RandomState(1)
    w = rng.randn(3, 3, 3, 4).astype(np.float32)
    real, fake = rng.rand(2, 8, 8, 3).astype(np.float32), rng.rand(2, 8, 8, 3).astype(np.float32)
    alpha = np.array(jax.random.uniform(jax.random.PRNGKey(3), (2, 1, 1, 1)))
    weight = rng.rand(2, 8, 8, 3).astype(np.float32) if which.endswith('weighted') else None

    def jax_loss(w_):
        d = lambda x: _conv_d(w_, x, 'jax')  # noqa: E731
        if which == 'r1':
            return jax_gan_loss.r1_penalty(d, jnp.asarray(real))
        return jax_gan_loss.gradient_penalty_loss(
            d, jnp.asarray(real), jnp.asarray(fake), jax.random.PRNGKey(3),
            None if weight is None else jnp.asarray(weight))

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    d = lambda x: _conv_d(wt, x, 'torch')  # noqa: E731
    if which == 'r1':
        got = port_gan_loss.r1_penalty(d, nchw(real))
    else:
        got = port_gan_loss.gradient_penalty_loss(
            d, nchw(real), nchw(fake), alpha=torch.from_numpy(alpha).view(2, 1, 1, 1),
            weight=None if weight is None else nchw(weight))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    assert_close(wt.grad.numpy(), want_grad, 1e-5, which)


def test_path_length_penalty_matches_jax():
    """Value, path lengths, the new running mean and the gradient with
    respect to the image function's weight, H != W (the noise is divided
    by sqrt(H * W))."""
    rng = np.random.RandomState(2)
    a = rng.randn(5, 6 * 4 * 3).astype(np.float32) * 0.3
    latents = rng.randn(2, 3, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (2, 6, 4, 3)))

    def jax_loss(a_):
        fake = lambda w: jnp.tanh(jnp.einsum('nlf,fk->nk', w, a_)).reshape(2, 6, 4, 3)  # noqa
        pen, lengths, mean = jax_gan_loss.g_path_regularize(fake, jnp.asarray(latents), 0.5, key)
        return pen, (lengths, mean)

    (want, (want_len, want_mean)), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)

    def fake(w):
        return torch.tanh(torch.einsum('nlf,fk->nk', w, at)).reshape(2, 6, 4, 3).permute(0, 3, 1, 2)

    got, lengths, mean = port_gan_loss.g_path_regularize(fake, torch.from_numpy(latents), 0.5,
                                                         nchw(noise))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    assert mean.item() == pytest.approx(float(want_mean), rel=1e-6)
    assert_close(lengths.numpy(), want_len, 1e-6, 'lengths')
    assert_close(at.grad.numpy(), want_grad, 1e-5, 'grad')


# --------------------------------------------------------------- networks
def jax_noise(batch, num_layers, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, 2**((i + 5) // 2), 2**((i + 5) // 2), 1).astype(np.float32)
            for i in range(num_layers)]


@pytest.fixture(scope='module')
def generators():
    """Both generators in both packages, at 32 with randomised weights."""
    out = {}
    for name, jax_cls, port_cls in (
            ('fir', jax_arch.StyleGAN2Generator, StyleGAN2Generator),
            ('bilinear', jax_bilinear.StyleGAN2GeneratorBilinear, StyleGAN2GeneratorBilinear)):
        net = jax_cls(**G_KW)
        shapes = jax.eval_shape(lambda: net.init({'params': jax.random.PRNGKey(0),
                                                  'noise': jax.random.PRNGKey(0)},
                                                 [jnp.zeros((1, 8))]))['params']
        params = randomized(shapes, 7)
        out[name] = (net, jax.jit(lambda p, s, n, net=net: net.apply({'params': p}, s, noise=n,
                                                                   return_latents=True)),
                     params, port_net(port_cls, params, **G_KW))
    return out


@pytest.mark.parametrize('name, codes', [('fir', 1), ('fir', 2), ('bilinear', 1),
                                         ('bilinear', 2)])
def test_generator_matches_jax(generators, name, codes):
    """One code, and two codes mixed at num_latent // 2, with explicit
    noise; the latents returned too."""
    net, apply, params, port = generators[name]
    rng = np.random.RandomState(codes)
    styles = [rng.randn(2, 8).astype(np.float32) for _ in range(codes)]
    noise = jax_noise(2, port.num_layers, codes)
    img, latent = apply(params, [jnp.asarray(s) for s in styles], [jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got, got_latent = port([torch.from_numpy(s) for s in styles],
                               noise=[nchw(n) for n in noise], return_latents=True)
    assert_close(nhwc(got), img, what='image')
    assert_close(got_latent.numpy(), latent, what='latent')
    assert got_latent.shape == (2, port.num_latent, 8)


@pytest.mark.parametrize('stddev_group, batch', [(2, 4), (4, 4), (4, 3)])
def test_discriminator_matches_jax(stddev_group, batch):
    """The minibatch stddev over groups of min(batch, stddev_group)."""
    net = jax_arch.StyleGAN2Discriminator(out_size=32, channel_multiplier=1, narrow=0.25,
                                          stddev_group=stddev_group)
    x = np.random.RandomState(3).randn(batch, 32, 32, 3).astype(np.float32)
    params = randomized(jax.eval_shape(net.init, jax.random.PRNGKey(0), x)['params'], 5)
    port = port_net(StyleGAN2Discriminator, params, out_size=32, channel_multiplier=1,
                    narrow=0.25, stddev_group=stddev_group)
    with torch.no_grad():
        got = port(nchw(x))
    assert_close(got.numpy(), jax.jit(net.apply)({'params': params}, x))


# ------------------------------------------------------------------ model
MODEL_OPT = {
    'name': 'test_sg2', 'model_type': 'StyleGAN2Model', 'num_gpu': 1, 'manual_seed': 0,
    'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
    'network_g': {'type': 'StyleGAN2Generator', 'out_size': 16, 'num_style_feat': 8,
                  'num_mlp': 2, 'channel_multiplier': 1, 'narrow': 0.25},
    'network_d': {'type': 'StyleGAN2Discriminator', 'out_size': 16, 'channel_multiplier': 1,
                  'narrow': 0.25, 'stddev_group': 2},
    'path': {'pretrain_network_g': None, 'pretrain_network_d': None},
    'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3}, 'optim_d': {'type': 'Adam', 'lr': 2e-3},
              'total_iter': 100, 'r1_reg_weight': 10, 'path_reg_weight': 2,
              'net_g_reg_every': 2, 'net_d_reg_every': 2, 'mixing_prob': 0.5,
              'path_batch_shrink': 2,
              'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus', 'loss_weight': 1.0}},
    'val': {'num_val_samples': 2}}
# Adam's step is lr * g / (|g| + eps): at eps 1e-8 it is the gradient's sign,
# which float32 noise flips where g is near 0; both packages run at eps 1 here
ADAM_EPS = 1.


class NoiseFromKey:
    """The JAX generator with its noise maps drawn explicitly from the
    ``noise`` key it is applied with (map i from ``fold_in(key, i)``), so
    that a test can hand the port the same maps."""

    def __init__(self, net):
        self.net = net

    def __getattr__(self, name):
        return getattr(self.net, name)

    def apply(self, variables, styles, rngs=None, input_is_latent=False, **kwargs):
        first = styles[0] if isinstance(styles, (list, tuple)) else styles
        noise = [jnp.asarray(n) for n in key_noise(rngs['noise'], first.shape[0],
                                                  self.net.num_layers)]
        return self.net.apply(variables, styles, input_is_latent=input_is_latent, noise=noise,
                              **kwargs)


def key_noise(key, batch, num_layers):
    return [jax.random.normal(jax.random.fold_in(key, i),
                              (batch, 2**((i + 5) // 2), 2**((i + 5) // 2), 1))
            for i in range(num_layers)]


def step_draws(model, step_rng, batch, out_size):
    """The port's draws of the JAX step ``step_rng``, as ``gan_step`` makes
    them from its eight keys."""
    keys = jax.random.split(step_rng, 8)
    layers = model.net_g.num_layers
    path_batch = max(1, batch // model.path_batch_shrink)

    def codes(key, n):
        return [torch.from_numpy(np.array(c)) for c in model._mixing_noise(key, n)]

    def maps(key, n):
        return [nchw(m) for m in key_noise(key, n, layers)]

    return {'d_codes': codes(keys[0], batch), 'd_noise': maps(keys[1], batch),
            'g_codes': codes(keys[2], batch), 'g_noise': maps(keys[3], batch),
            'path_codes': codes(keys[4], path_batch), 'path_noise': maps(keys[5], path_batch),
            'path_proj': nchw(jax.random.normal(keys[6], (path_batch, out_size, out_size, 3)))}


def port_opt(tmp):
    opt = copy.deepcopy(MODEL_OPT)
    opt['num_gpu'] = 0
    opt['path'].update(models=str(tmp / 'models'), training_states=str(tmp / 'states'),
                       visualization=str(tmp / 'vis'))
    return opt


def with_eps(get_optimizer):
    def patched(self, optim_type, params, lr, **kwargs):
        return get_optimizer(self, optim_type, params, lr, eps=ADAM_EPS, **kwargs)
    return patched


@pytest.fixture(scope='module')
def model_pair(tmp_path_factory):
    """The JAX model (its generator's noise drawn from its keys, Adam at
    ADAM_EPS) and the port's model holding the same randomised weights."""
    tmp = tmp_path_factory.mktemp('sg2')
    adam = lambda lr, adam=optax.adam, **kw: adam(lr, eps=ADAM_EPS, **kw)  # noqa: E731
    # on one of the host's eight CPU devices: on all eight the step runs eight times
    one_device = mock.patch('basicsr4rs_tpu.models.base_model.create_mesh',
                            lambda opt: jax_mesh.create_mesh(opt, jax.devices()[:1]))
    with mock.patch.object(jax_stylegan2_model, 'jit_init', _shapes_only), one_device, \
            mock.patch.object(jax_stylegan2_model.optax, 'adam', adam):
        ref = jax_build_model(copy.deepcopy(MODEL_OPT))
    ref.net_g = NoiseFromKey(ref.net_g)
    g = randomized(jax.device_get(ref.state.params), 11)
    d = randomized(jax.device_get(ref.d_state.params), 12)
    ref.state = ref.state.replace(params=g, ema_params=g)
    ref.d_state = ref.d_state.replace(params=d)
    from basicsr4rs_torch.models import stylegan2_model as port_module
    with mock.patch.object(port_module.StyleGAN2Model, 'get_optimizer',
                           with_eps(port_module.StyleGAN2Model.get_optimizer)):
        port = port_build_model(port_opt(tmp))
    for net, params in ((port.net_g, g), (port.net_g_ema, g), (port.net_d, d)):
        missing, unexpected = net.load_state_dict(
            jax_params_to_state_dict(params, getattr(type(net), 'JAX_KEY_RULES', None)),
            strict=False)
        assert not unexpected and all(k.startswith('noises.') for k in missing)
    return ref, port


REAL = np.random.RandomState(5).rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
LOG_KEYS = ['l_d', 'real_score', 'fake_score', 'l_d_r1', 'l_g', 'l_g_path', 'path_length']


def test_model_steps_match_jax(model_pair):
    """Four steps at net_g_reg_every = net_d_reg_every = 2 from the same
    weights, codes and noise: the logs every step (R1 and the path term
    non-zero on steps 2 and 4 only), then G, its EMA, D and the mean path
    length."""
    ref, port = model_pair
    before = {name: {k: v.clone() for k, v in net.state_dict().items()}
              for name, net in (('g', port.net_g), ('ema', port.net_g_ema), ('d', port.net_d))}
    for step in range(1, 5):
        rng_before = ref.rng
        ref.feed_data({'gt': REAL})
        ref.optimize_parameters(step)
        draws = step_draws(ref, jax.random.split(rng_before)[1], 2, 16)
        port.feed_data({'gt': nchw(REAL)})
        with mock.patch.object(port, 'draw_step', lambda batch, regularize_g: draws):
            port.optimize_parameters(step)
        got, want = port.get_current_log(), ref.get_current_log()
        assert list(got) == list(want) == LOG_KEYS
        for key in LOG_KEYS:
            assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), (step, key)
        regularized = step % 2 == 0
        assert (got['l_d_r1'] != 0) == regularized and (got['l_g_path'] != 0) == regularized
    assert port.current_step() == ref.current_step() == 4
    assert port.mean_path_length.item() == pytest.approx(
        float(ref.state.stats['mean_path_length']), rel=1e-4)
    for name, net, tree in (('g', port.net_g, ref.state.params),
                            ('ema', port.net_g_ema, ref.state.ema_params),
                            ('d', port.net_d, ref.d_state.params)):
        want_sd = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree),
                                           getattr(type(net), 'JAX_KEY_RULES', None))
        for key, want in want_sd.items():
            got, start = net.state_dict()[key].double(), before[name][key].double()
            change = (want.double() - start).abs().max().item()
            err = (got - want.double()).abs().max().item()
            assert change > 0, (name, key)
            assert err <= 1e-3 * change + 1e-6 * want.abs().max().item(), f'{name} {key}: {err:.3e}'


def test_model_save_and_resume_repeat_the_run(tmp_path):
    """Two steps, save, a new model resumed from the files (as
    ``check_resume`` points it), two steps: the same weights, EMA, D,
    optimizer moments and mean path length as four steps in one run, and
    validation's sample grid."""
    opt = port_opt(tmp_path)
    real = {'gt': nchw(REAL)}
    torch.manual_seed(0)
    whole = port_build_model(copy.deepcopy(opt))
    for step in range(1, 5):
        whole.feed_data(real)
        whole.optimize_parameters(step)
    torch.manual_seed(0)
    first = port_build_model(copy.deepcopy(opt))
    for step in range(1, 3):
        first.feed_data(real)
        first.optimize_parameters(step)
    first.save(0, 2)
    resumed_opt = copy.deepcopy(opt)
    resumed_opt['path'].update(pretrain_network_g=str(tmp_path / 'models' / 'net_g_2.pth'),
                               pretrain_network_d=str(tmp_path / 'models' / 'net_d_2.pth'),
                               resume_state=str(tmp_path / 'states' / '2.state'))
    second = port_build_model(resumed_opt)
    second.resume_training(torch.load(tmp_path / 'states' / '2.state', weights_only=True))
    for step in range(3, 5):
        second.feed_data(real)
        second.optimize_parameters(step)
    assert second.current_step() == 4
    assert torch.equal(second.mean_path_length, whole.mean_path_length)
    for a, b in ((whole.net_g, second.net_g), (whole.net_g_ema, second.net_g_ema),
                 (whole.net_d, second.net_d)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    m1, m2 = whole.optimizer_g.state_dict()['state'], second.optimizer_g.state_dict()['state']
    assert all(torch.equal(m1[i]['exp_avg_sq'], m2[i]['exp_avg_sq']) for i in m1)
    second.nondist_validation(None, 4, None, True)
    grid = cv2.imread(str(tmp_path / 'vis' / 'train' / 'train_4.png'))
    assert grid.shape == (16, 32, 3)


# ---------------------------------------------------------------- dataset
def test_ffhq_dataset_matches_jax(tmp_path):
    """Folder mode: the same flips (a generator seeded by manual_seed) and
    [-1, 1] normalisation, item by item."""
    rng = np.random.RandomState(0)
    for i in range(4):
        cv2.imwrite(str(tmp_path / f'{i:05d}.png'), (rng.rand(8, 8, 3) * 255).astype(np.uint8))
    opt = {'name': 'ffhq', 'type': 'FFHQDataset', 'dataroot_gt': str(tmp_path),
           'io_backend': {'type': 'disk'}, 'use_hflip': True, 'mean': [0.5, 0.5, 0.5],
           'std': [0.5, 0.5, 0.5], 'phase': 'train', 'manual_seed': 3}
    port, ref = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert len(port) == len(ref) == 4
    flips = 0
    for i in range(4):
        got, want = port[i], ref[i]
        assert got['gt_path'] == want['gt_path']
        # the JAX package's items are HWC
        np.testing.assert_array_equal(got['gt'].numpy(), np.asarray(want['gt']).transpose(2, 0, 1))
        img = cv2.imread(got['gt_path'])[..., ::-1].astype(np.float32) / 255. * 2 - 1
        flips += not np.allclose(got['gt'].numpy(), img.transpose(2, 0, 1), atol=1e-6)
    assert 0 < flips < 4
    assert got['gt'].min() >= -1 and got['gt'].max() <= 1

