"""Data-parallel ESRGAN on two gloo ranks (``tests/torch_dist_worker.py``'s
``model`` job), against one port process at the global batch and against
the JAX package's ``ESRGANModel`` fed the same global batches.

MSRResNet at 8 features and the VGG-style discriminator at 8 features on
128x128 (9 synced BatchNorms), an L1 pixel loss and the relativistic
vanilla GAN loss, EMA 0.9, 2 SGD steps at 1e-3 (at 0.05 a second step turns
the float32 rounding of the first into 1e-2 of the largest gradient), 2
rows a rank, the second rank's rows shifted. On two ranks the four
relativistic means and the BatchNorm statistics are the global batch's.
Rank 0 alone loads the ``.pth`` files (the discriminator's parameters only:
the JAX package reads no running statistics); rank 1 starts from its own
random weights.

Against one process: parameters, BatchNorm buffers and EMA within
``F32_ROUNDING``, losses to the log's digits. Against the JAX package: the
bounds of ``test_torch_dist_train.py`` (losses rtol 5e-4 and atol 5e-5,
parameters atol 1e-5 + rtol 1e-3). A control with the synchronisation of
statistics and means off fails both."""

import copy
import json
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.discriminator_arch import VGGStyleDiscriminator

from test_torch_esrgan import gan_opt, jax_model, jax_state_dict, nhwc, write_inputs
from torch_dist_worker import one_process, states_close, torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)
JAX_BOUNDS = dict(atol=1e-5, rtol=1e-3)
NETS = ('net_g', 'net_g_ema', 'net_d')


def esrgan_opt(tmp):
    opt = gan_opt('ESRGANModel', tmp, {'type': 'SGD', 'lr': 1e-3})
    opt['train'].pop('perceptual_opt')
    for key in ('dist', 'rank', 'world_size'):
        opt.pop(key)
    return opt


def global_batches():
    rng = np.random.RandomState(4)
    out = []
    for _ in range(2):
        lq = rng.rand(4, 3, 32, 32).astype(np.float32)
        gt = rng.rand(4, 3, 128, 128).astype(np.float32)
        lq[2:] = lq[2:] * 0.5 + 0.4
        gt[2:] = gt[2:] * 0.5 + 0.4
        out.append({'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt)})
    return out


def jax_run(opt, batches):
    """The JAX ``ESRGANModel`` on the global batches: its logs and its G,
    EMA and D (with statistics) as state dicts."""
    ref = jax_model(dict(copy.deepcopy(opt), dist=False, rank=0, world_size=1))
    logs = []
    for step, batch in enumerate(batches, 1):
        ref.feed_data({k: nhwc(v.numpy()) for k, v in batch.items()})
        ref.optimize_parameters(step)
        logs.append(ref.get_current_log())
    states = {'net_g': jax_state_dict(ref.state.params),
              'net_g_ema': jax_state_dict(ref.state.ema_params),
              'net_d': jax_state_dict(ref.d_state.params, VGGStyleDiscriminator.JAX_KEY_RULES,
                                      ref.d_state.stats)}
    return {'losses': logs, 'states': states}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dist_esrgan')
    write_inputs(tmp)
    opt = esrgan_opt(tmp)
    batches = global_batches()
    torch.save(batches, tmp / 'batches.pt')
    jobs = [{'kind': 'model', 'name': name, 'opt': opt, 'batches': str(tmp / 'batches.pt'),
             'nets': list(NETS), 'control': control}
            for name, control in (('esrgan', False), ('esrgan_control', True))]
    (tmp / 'job.json').write_text(json.dumps(jobs))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torchrun, 2, osp.join(REPO, 'tests', 'torch_dist_worker.py'),
                            str(tmp), str(tmp / 'job.json'))
        one = one_process(opt, batches, NETS)
        ref = jax_run(opt, batches)
        ranks.result()
    return {'one': one, 'jax': ref,
            'two': torch.load(tmp / 'esrgan.pt', weights_only=False),
            'control': torch.load(tmp / 'esrgan_control.pt', weights_only=False),
            'start': torch.load(tmp / 'g.pth', weights_only=True)['params']}


def misses(got, want, atol, rtol):
    return [f'{label} {key}' for label, state in want['states'].items()
            for key, value in state.items() if not key.endswith('num_batches_tracked')
            and not states_close({0: {0: got['states'][label][key]}}, {0: {0: value}}, atol,
                                 rtol)]


@pytest.mark.parametrize('label', NETS)
def test_two_ranks_train_as_one_process_at_the_global_batch(runs, label):
    """G, its EMA, and D with its BatchNorm buffers after 2 steps: one
    process's within ``F32_ROUNDING``, the same on both ranks; G moved."""
    got, want = runs['two'], runs['one']
    assert got['same_on_ranks']
    assert misses(got, {'states': {label: want['states'][label]}}, **F32_ROUNDING) == []
    assert any(not torch.equal(v, runs['start'][k]) for k, v in got['states']['net_g'].items())


def test_two_ranks_log_one_process_losses(runs):
    got, want = runs['two']['losses'], runs['one']['losses']
    assert [list(s) for s in got] == [list(s) for s in want]
    for g, w in zip(got, want):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-4, abs=1e-7), key


def test_two_ranks_match_the_jax_model_at_the_global_batch(runs):
    """The JAX ``ESRGANModel`` fed the global batches: the logged losses and
    every parameter of G, the EMA and D, with D's running statistics."""
    got, want = runs['two'], runs['jax']
    assert [list(s) for s in got['losses']] == [list(s) for s in want['losses']]
    for g, w in zip(got['losses'], want['losses']):
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=5e-4, atol=5e-5)
    assert misses(got, want, **JAX_BOUNDS) == []


def test_each_ranks_own_statistics_and_means_fail_both(runs):
    """The control: each rank's BatchNorm statistics and relativistic means
    its own."""
    control = runs['control']
    assert misses(control, runs['one'], **F32_ROUNDING)
    assert misses(control, runs['jax'], **JAX_BOUNDS)
