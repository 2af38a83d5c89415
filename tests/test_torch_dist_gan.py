"""Data-parallel training of HiFaceGAN, the video GAN and DUF on two gloo
ranks against one port process at the global batch, through one torchrun of
``tests/torch_dist_worker.py`` (``model`` jobs), 2 SGD steps each (the
video GAN 1):

* ``HiFaceGANModel`` as published (``spectralspadebatch3x3``, lsgan,
  feature matching) at 4 features on 64x64, one row a rank: the SPADE
  ``batch`` norm takes the two rows' statistics, where a rank's own would
  be an instance norm; SGD at 1e-3 (see ``hifacegan_opt``);
* ``VideoRecurrentGANModel``: BasicVSR at width 8 on one 3-frame clip a
  rank (LQ 64x64; its SpyNet and ``flow_warp`` under the ranks), the
  VGG-style discriminator at 8 features with the synced BatchNorm on the
  frames folded into the batch;
* ``VideoBaseModel`` with DUF (16 layers, 13 BatchNorm3d in the generator,
  under DDP), 7-frame windows of 16x16, two a rank.

Rank 0 alone loads the ``.pth`` files; rank 1 starts from its own random
weights, which rank 0's must replace. The second rank's rows are shifted,
so that the ranks' statistics differ. Parameters, BatchNorm buffers and EMA
within float32 rounding of the summation order (``F32_ROUNDING``). The
video GAN's discriminator (a 256x256 map through BatchNorm over 6 frames)
has a gradient that one float32 process already takes 2e-3 of its largest
entry away from float64's, and a second step amplifies that: it takes one
step, at SGD's 1e-3, and its gradients are also held to 1e-3 of each
network's largest. The logged losses to the log's digits (``%.4e``: 1e-4);
and a control run with the synchronisation of statistics off (each rank's
own) must fail the same tolerance."""

import json
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import build_network
from basicsr4rs_torch.utils.options import yaml_load

from torch_dist_worker import one_process, states_close, torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)
LOSS_RTOL = 1e-4   # one unit of the log's %.4e
SGD = {'type': 'SGD', 'lr': 0.05}
L1 = {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}


def hifacegan_opt():
    opt = yaml_load(osp.join(REPO, 'options', 'train', 'HiFaceGAN', 'train_hifacegan.yml'))
    for key in ('datasets', 'logger', 'dist_params'):
        opt.pop(key, None)
    opt['network_g'].update(num_feat=4, crop_size=64)
    opt['network_d'].update(num_feat=4)
    opt['train'].pop('perceptual_opt')
    # at SGD's 0.05 the LIP encoder's gates (exp of 12 sigmoid) turn the
    # float32 rounding of a first step's update into 0.2% of the second's
    sgd = dict(SGD, lr=1e-3)
    opt['train'].update(optim_g=dict(sgd), optim_d=dict(sgd), pixel_opt=dict(L1))
    opt.update(num_gpu=0, is_train=True, manual_seed=0)
    return opt


def gan_opt(model_type, network_g, network_d, lr=SGD['lr']):
    sgd = dict(SGD, lr=lr)
    return {'name': 'gan', 'model_type': model_type, 'scale': 4, 'num_gpu': 0, 'manual_seed': 0,
            'is_train': True, 'network_g': network_g, 'network_d': network_d, 'path': {},
            'train': {'ema_decay': 0.9, 'net_d_iters': 1, 'net_d_init_iters': 0,
                      'optim_g': dict(sgd), 'optim_d': dict(sgd), 'pixel_opt': dict(L1),
                      'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla', 'loss_weight': 0.5}},
            'val': {'val_freq': 100}}


CASES = {
    'hifacegan': (hifacegan_opt(), ('net_g', 'net_d'),
                  lambda rng: {'lq': rng.rand(2, 3, 64, 64), 'gt': rng.rand(2, 3, 64, 64)}),
    'videogan': (gan_opt('VideoRecurrentGANModel',
                         {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1},
                         {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 8,
                          'input_size': 256}, lr=1e-3),
                 ('net_g', 'net_d', 'net_g_ema'),
                 lambda rng: {'lq': rng.rand(2, 3, 3, 64, 64), 'gt': rng.rand(2, 3, 3, 256, 256)}),
    'duf': ({'name': 'duf', 'model_type': 'VideoBaseModel', 'scale': 4, 'num_gpu': 0,
             'manual_seed': 0, 'is_train': True,
             'network_g': {'type': 'DUF', 'num_layer': 16, 'scale': 4}, 'path': {},
             'train': {'ema_decay': 0.9, 'optim_g': dict(SGD), 'pixel_opt': dict(L1)},
             'val': {'val_freq': 100}},
            ('net_g', 'net_g_ema'),
            lambda rng: {'lq': rng.rand(4, 7, 3, 16, 16), 'gt': rng.rand(4, 3, 64, 64)}),
}


def batches(make, seed, steps=2):
    """``steps`` global batches, the second half of the rows (the second
    rank's) shifted and scaled."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in make(rng).items()}
        for v in batch.values():
            v[len(v) // 2:] = v[len(v) // 2:] * 0.5 + 0.4
        out.append(batch)
    return out


def with_inits(opt, tmp, name):
    """``opt`` loading seeded random weights of its networks (the whole
    state: BatchNorm buffers too)."""
    opt = json.loads(json.dumps(opt))
    torch.manual_seed(7)
    for net_key, label in (('network_g', 'g'), ('network_d', 'd')):
        if net_key in opt:
            path = tmp / f'{name}_{label}.pth'
            torch.save({'params': build_network(dict(opt[net_key])).state_dict()}, path)
            opt['path'][f'pretrain_network_{label}'] = str(path)
            opt['path'][f'strict_load_{label}'] = True
    return opt


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two-rank runs and their controls (torchrun, in a thread) and the
    one-process runs (here), from the same files and batches."""
    tmp = tmp_path_factory.mktemp('dist_gan')
    jobs, local = [], {}
    for seed, (name, (opt, nets, make)) in enumerate(CASES.items()):
        opt = with_inits(opt, tmp, name)
        data = batches(make, seed, 1 if name == 'videogan' else 2)
        torch.save(data, tmp / f'{name}_batches.pt')
        local[name] = (opt, data, nets)
        for control in (False, True):
            jobs.append({'kind': 'model', 'name': name + ('_control' if control else ''),
                         'opt': opt, 'batches': str(tmp / f'{name}_batches.pt'), 'nets': list(nets),
                         'control': control})
    (tmp / 'job.json').write_text(json.dumps(jobs))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torchrun, 2, osp.join(REPO, 'tests', 'torch_dist_worker.py'),
                            str(tmp), str(tmp / 'job.json'))
        one = {name: one_process(*args) for name, args in local.items()}
        ranks.result()
    two = {job['name']: torch.load(tmp / f'{job["name"]}.pt', weights_only=False)
           for job in jobs}
    return {'one': one, 'two': two, 'init': {name: opt for name, (opt, _, _) in local.items()}}


def misses(name, got, want):
    """The entries of the two-rank run (or a control) beyond the tolerance
    against one process's: every state entry within ``F32_ROUNDING``; for
    the video GAN also its step's gradients within 1e-3 of the network's
    largest."""
    out = [f'{label} {key}' for label, state in want['states'].items()
           for key, value in state.items()
           if not states_close({0: {0: got['states'][label][key]}}, {0: {0: value}},
                               **F32_ROUNDING)]
    if name == 'videogan':
        for step, (g, w) in enumerate(zip(got['grads'], want['grads'])):
            for net in ('net_g', 'net_d'):
                keys = [k for k in w if k.startswith(net)]
                biggest = max(w[k].abs().max().item() for k in keys)
                out += [f'step {step} gradient {k}' for k in keys
                        if (g[k] - w[k]).abs().max().item() > 1e-3 * biggest]
    return out


def inits(opt):
    return {f'net_{label}': torch.load(opt['path'][f'pretrain_network_{label}'],
                                       weights_only=True)['params']
            for label in ('g', 'd') if f'pretrain_network_{label}' in opt['path']}


@pytest.mark.parametrize('name', list(CASES))
def test_two_ranks_train_as_one_process_at_the_global_batch(runs, name):
    """Every network's parameters and buffers (and the EMA) after 2 steps
    one process's within the case's tolerance, the same on both ranks, and
    moved from the start."""
    got, want = runs['two'][name], runs['one'][name]
    start = inits(runs['init'][name])
    assert got['same_on_ranks']
    assert misses(name, got, want) == []
    assert any(not torch.equal(v, start['net_g'][k]) for k, v in got['states']['net_g'].items()
               if v.is_floating_point())


@pytest.mark.parametrize('name', list(CASES))
def test_two_ranks_log_one_process_losses(runs, name):
    got, want = runs['two'][name]['losses'], runs['one'][name]['losses']
    assert [list(s) for s in got] == [list(s) for s in want]
    for g, w in zip(got, want):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=LOSS_RTOL, abs=1e-7), key


@pytest.mark.parametrize('name', list(CASES))
def test_each_ranks_own_statistics_fail_the_same_tolerance(runs, name):
    """The control: the norms over each rank's rows give other weights."""
    assert misses(name, runs['two'][f'{name}_control'], runs['one'][name])
