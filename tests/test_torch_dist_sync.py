"""The port's cross-rank statistics on two gloo ranks against the JAX
functions on the whole batch, through one torchrun of
``tests/torch_dist_worker.py`` (``units`` jobs):

* the synced ``_FlaxBatchStats`` (``archs/arch_util.py``) against Flax's
  ``BatchNorm(momentum=0.9)`` in training: the output, the output of a pass
  under ``frozen_batch_stats``, the input's and the scale's and bias's
  gradients, the running mean and biased variance; 5 rows split 3 + 2;
* ``r1_penalty``, ``gradient_penalty_loss`` (weighted) and
  ``g_path_regularize`` (``losses/gan_loss.py``) against the JAX package's:
  value and the gradient of the discriminator's or the image function's
  weight; the path lengths and the new running mean; 3 rows split 2 + 1.

Each rank's loss of the norm is the sum over its own rows, so that the
ranks' losses add up to the whole batch's: the scale's and bias's
gradients are then the sum over the ranks. The penalties are the global
batch's on every rank, and their gradients the mean over the ranks, as
the models' exchange takes it. The rows of the two ranks differ (the second
rank's are shifted), and a control job with the synchronisation off
(``no_stat_sync``: each rank's statistics and means its own) must fail the
same tolerances. Float32: 1e-5 of each tensor's largest magnitude."""

import json
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_tpu.losses import gan_loss as jax_gan_loss

from torch_dist_worker import torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
TOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def inputs():
    """The whole batch of every unit, NHWC for JAX; the second rank's rows
    shifted so that the ranks' statistics differ."""
    rng = np.random.RandomState(3)
    bn_x = rng.randn(5, 3, 3, 4).astype(np.float32)
    bn_x[3:] = bn_x[3:] * 2. + 1.5
    real = rng.rand(3, 8, 8, 3).astype(np.float32)
    real[2:] += 1.
    lat = rng.randn(3, 3, 5).astype(np.float32)
    lat[2:] *= 3.
    return {'bn_x': bn_x, 'bn_w': rng.randn(5, 3, 3, 4).astype(np.float32),
            'bn_weight': rng.rand(4).astype(np.float32) + 0.5,
            'bn_bias': rng.randn(4).astype(np.float32),
            'd_weight': rng.randn(3, 3, 3, 4).astype(np.float32),
            'real': real, 'fake': rng.rand(3, 8, 8, 3).astype(np.float32),
            'gp_weight': rng.rand(3, 8, 8, 3).astype(np.float32),
            'alpha': np.array(jax.random.uniform(jax.random.PRNGKey(3), (3, 1, 1, 1))),
            'latents': lat, 'path_a': (rng.randn(5, 6 * 4 * 3) * 0.3).astype(np.float32),
            'path_noise': np.array(jax.random.normal(jax.random.PRNGKey(4), (3, 6, 4, 3)))}


def for_ranks(x):
    """The inputs as the ranks take them: torch, NCHW, the conv weight OIHW."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    for k in ('bn_x', 'bn_w', 'real', 'fake', 'gp_weight', 'path_noise'):
        t[k] = nchw(x[k])
    t['d_weight'] = torch.from_numpy(np.ascontiguousarray(x['d_weight'].transpose(3, 2, 0, 1)))
    t['split'] = ['bn_x', 'bn_w', 'real', 'fake', 'gp_weight', 'alpha', 'latents', 'path_noise']
    return t


def conv_d(w):
    def d(x):
        y = jax.lax.conv_general_dilated(x, w, (1, 1), 'SAME',
                                         dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        return jnp.tanh(y).mean(axis=(1, 2, 3)) * 3.
    return d


def jax_reference(x):
    """Every unit on the whole batch in JAX."""
    out = {}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x['bn_x']))
    params = {'scale': jnp.asarray(x['bn_weight']), 'bias': jnp.asarray(x['bn_bias'])}

    def bn_loss(xx, p):
        y, upd = bn.apply({'params': p, 'batch_stats': variables['batch_stats']}, xx,
                          mutable=['batch_stats'])
        return jnp.sum(y * x['bn_w']), (y, upd['batch_stats'])

    (_, (y, stats)), (gx, gp) = jax.value_and_grad(bn_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x['bn_x']), params)
    out['bn'] = {'y': to_nchw(y), 'frozen_y': to_nchw(y), 'x_grad': to_nchw(gx),
                 'weight_grad': np.asarray(gp['scale']), 'bias_grad': np.asarray(gp['bias']),
                 'running_mean': np.asarray(stats['mean']),
                 'running_var': np.asarray(stats['var'])}
    real, fake = jnp.asarray(x['real']), jnp.asarray(x['fake'])

    def r1(w):
        return jax_gan_loss.r1_penalty(conv_d(w), real)

    def gp_loss(w):
        return jax_gan_loss.gradient_penalty_loss(conv_d(w), real, fake, jax.random.PRNGKey(3),
                                                  jnp.asarray(x['gp_weight']))

    for name, fn in (('r1', r1), ('gp', gp_loss)):
        value, grad = jax.value_and_grad(fn)(jnp.asarray(x['d_weight']))
        out[name] = {'value': np.asarray(value), 'grad': np.asarray(grad).transpose(3, 2, 0, 1)}

    def path(a):
        def fake_fn(w):
            return jnp.tanh(jnp.einsum('nlf,fk->nk', w, a)).reshape(len(w), 6, 4, 3)
        pen, lengths, mean = jax_gan_loss.g_path_regularize(
            fake_fn, jnp.asarray(x['latents']), 0.5, jax.random.PRNGKey(4))
        return pen, (lengths, mean)

    (pen, (lengths, mean)), grad = jax.value_and_grad(path, has_aux=True)(
        jnp.asarray(x['path_a']))
    out['path'] = {'value': np.asarray(pen), 'lengths': np.asarray(lengths),
                   'mean': np.asarray(mean), 'grad': np.asarray(grad)}
    return out


def merged(ranks):
    """The ranks' results as one batch's: rows joined, the norm's parameter
    gradients summed, the penalties' gradients averaged, the running
    statistics and the penalties' values rank 0's (checked equal)."""
    out = {}
    bn = [r['bn'] for r in ranks]
    out['bn'] = {k: torch.cat([b[k] for b in bn]).numpy() for k in ('y', 'frozen_y', 'x_grad')}
    out['bn'].update({k: sum(b[k] for b in bn).numpy() for k in ('weight_grad', 'bias_grad')})
    out['bn'].update({k: bn[0][k].numpy() for k in ('running_mean', 'running_var')})
    for name in ('r1', 'gp', 'path'):
        units = [r[name] for r in ranks]
        out[name] = {'value': units[0]['value'].numpy(),
                     'grad': (sum(u['grad'] for u in units) / len(units)).numpy()}
        out[name]['same_value'] = all(torch.equal(u['value'], units[0]['value']) for u in units)
        if name == 'path':
            out[name]['lengths'] = torch.cat([u['lengths'] for u in units]).numpy()
            out[name]['mean'] = units[0]['mean'].numpy()
    return out


def misses(got, want):
    """The names of the entries beyond 1e-5 of the reference's largest
    magnitude."""
    return [k for k, w in want.items()
            if np.abs(np.asarray(got[k], np.float64) - w).max() > TOL * max(np.abs(w).max(), 1e-30)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dist_sync')
    x = inputs()
    torch.save(for_ranks(x), tmp / 'inputs.pt')
    job = tmp / 'job.json'
    job.write_text(json.dumps([
        {'kind': 'units', 'name': name, 'inputs': str(tmp / 'inputs.pt'), 'control': control}
        for name, control in (('synced', False), ('control', True))]))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torchrun, 2, osp.join(REPO, 'tests', 'torch_dist_worker.py'),
                            str(tmp), str(job))
        want = jax_reference(x)
        ranks.result()
    return {name: merged(torch.load(tmp / f'{name}.pt', weights_only=False))
            for name in ('synced', 'control')} | {'jax': want}


@pytest.mark.parametrize('entry', ['y', 'frozen_y', 'x_grad', 'weight_grad', 'bias_grad',
                                   'running_mean', 'running_var'])
def test_synced_batchnorm_is_flax_batchnorm_on_the_whole_batch(runs, entry):
    """Output, the frozen pass's output, the input's gradient row by row,
    the scale's and bias's gradients, and the running mean and biased
    variance after one update (the frozen pass left them). With each rank's
    own statistics every entry is off but the bias's gradient, the sum of
    the output's whatever the statistics."""
    want = {entry: runs['jax']['bn'][entry]}
    assert misses(runs['synced']['bn'], want) == []
    assert misses(runs['control']['bn'], want) == ([] if entry == 'bias_grad' else [entry])


@pytest.mark.parametrize('name', ['r1', 'gp', 'path'])
def test_global_means_are_the_jax_functions_on_the_whole_batch(runs, name):
    """The penalty's value (the same on both ranks) and its weight's
    gradient (the mean of the ranks'); for the path length also the lengths
    and the new running mean. With each rank's own means the value is off."""
    want = runs['jax'][name]
    got = runs['synced'][name]
    assert got['same_value']
    assert misses(got, want) == []
    control = runs['control'][name]
    assert 'value' in misses(control, want) or not control['same_value']
    assert misses(control, want)
