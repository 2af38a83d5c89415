"""Data-parallel StyleGAN2 and joint align-diffusion training on two gloo
ranks against one port process at the global batch, through one torchrun
of ``tests/torch_dist_worker.py`` (``model`` jobs):

* ``StyleGAN2Model`` at out_size 16 (narrow 0.25, 8 style features), 3
  rows a rank, 2 steps: the second both R1 and the path length (both
  ``reg_every`` 2), its path batch the JAX package's global rule, max(1,
  6 // 2) = 3 rows, split 2 + 1, and the discriminator's minibatch-stddev
  groups of 2 over the global batch (rows 3 apart: one of each rank's).
  The draws of every step are replayed (``replayed_draws``: each rank its
  rows of one global draw). StyleGAN2
  builds its Adam itself (betas from ``reg_every``): the gradients each
  optimizer was handed are compared, within 1e-5 of each network's
  largest, and the weights after the steps with Adam's eps at 1 (at 1e-8
  its first step is the gradient's sign, which float32 noise flips) within
  ``F32_ROUNDING``; ``mean_path_length`` the same. The control takes each
  rank's own means (the path batch splits unevenly).
* ``AlignJointDiffModel`` (the UNet at 64 channels over 24x24 latents of GT
  24, the align autoencoder and the LR encoder at 8 features; its four
  losses), 2 rows a rank, 2 SGD steps at 1e-3 with the fed timesteps and
  noise. It holds no cross-rank statistic: the control exchanges no
  gradient.

Rank 0 alone loads the ``.pth`` files; rank 1 starts from its own random
weights. The second rank's rows differ (shifted). Losses to the log's
digits (1e-4)."""

import copy
import json
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import build_network

from test_torch_resshift import _nonzero_
from torch_dist_worker import one_process, states_close, torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)
GRAD_TOL = 1e-5
ADAM_EPS = 1.

SG2 = {
    'name': 'sg2', 'model_type': 'StyleGAN2Model', 'num_gpu': 0, 'manual_seed': 0,
    'is_train': True,
    'network_g': {'type': 'StyleGAN2Generator', 'out_size': 16, 'num_style_feat': 8,
                  'num_mlp': 2, 'channel_multiplier': 1, 'narrow': 0.25},
    'network_d': {'type': 'StyleGAN2Discriminator', 'out_size': 16, 'channel_multiplier': 1,
                  'narrow': 0.25, 'stddev_group': 2},
    'path': {},
    'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3}, 'optim_d': {'type': 'Adam', 'lr': 2e-3},
              'r1_reg_weight': 10, 'path_reg_weight': 2, 'net_g_reg_every': 2,
              'net_d_reg_every': 2, 'mixing_prob': 0.5, 'path_batch_shrink': 2,
              'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus', 'loss_weight': 1.0}},
    'val': {'num_val_samples': 2}}
AE = {'num_in_ch': 12, 'num_out_ch': 6, 'num_feat': 8, 'num_block': 1}
JOINT = {
    'name': 'joint', 'model_type': 'AlignJointDiffModel', 'scale': 3, 'num_gpu': 0,
    'manual_seed': 0, 'is_train': True,
    'network_g': {'type': 'ResNetAE_SwinUNet', 'align_autoencoder_args': AE,
                  'lr_encoder_args': {'num_in_ch': 6, 'num_out_ch': 6, 'num_feat': 8,
                                      'num_block': 1},
                  'unet_args': {'image_size': 24, 'in_channels': 6, 'model_channels': 64,
                                'out_channels': 6, 'num_res_blocks': 1,
                                'attention_resolutions': [], 'channel_mult': [1],
                                'num_head_channels': 16, 'swin_embed_dim': 64, 'window_size': 4,
                                'mlp_ratio': 4, 'cond_lq': True, 'lq_size': 24}},
    'path': {'strict_load_g': True},
    'train': {'ema_decay': 0.9, 'use_amp': False, 'optim_g': {'type': 'SGD', 'lr': 1e-3},
              'decoder_opt': {'type': 'MSELoss', 'loss_weight': 1.0},
              'sr_opt': {'type': 'MSELoss', 'loss_weight': 0.5},
              'diffusion_opt': {'type': 'MSELoss', 'loss_weight': 0.7},
              'encoder_opt': {'type': 'EncoderLoss', 'strategy': 'gt', 'loss_weight': 0.3}},
    'diffusion': {'normalize_input': True, 'schedule_name': 'exponential', 'sf': 3,
                  'min_noise_level': 0.2, 'steps': 3, 'kappa': 2.0, 'etas_end': 0.99,
                  'schedule_kwargs': {'power': 0.3}, 'predict_type': 'xstart',
                  'timestep_respacing': None, 'latent_flag': False},
    'val': {'val_freq': 10}}


def sg2_inputs(tmp):
    """``.pth`` files of both networks (every parameter non-zero: the noise
    weights start at 0), two global batches of 6 real images and the
    replayed draws of both steps."""
    torch.manual_seed(0)
    opt = copy.deepcopy(SG2)
    for label in ('g', 'd'):
        net = _nonzero_(build_network(dict(opt[f'network_{label}'])), 5 + len(label))
        torch.save({'params': net.state_dict()}, tmp / f'sg2_{label}.pth')
        opt['path'][f'pretrain_network_{label}'] = str(tmp / f'sg2_{label}.pth')
    gen = torch.Generator().manual_seed(3)
    sizes = [4, 8, 8, 16, 16]   # the generator's noise maps at out_size 16
    batches, draws = [], []
    for step in (1, 2):
        real = torch.rand((6, 3, 16, 16), generator=gen) * 2 - 1
        real[3:] = real[3:] * 0.5 + 0.3
        batches.append({'gt': real})

        def codes(n):
            z1, z2 = torch.randn((2, n, 8), generator=gen)
            return [z1, z2 if step == 1 else z1]

        def maps(n):
            return [torch.randn((n, 1, s, s), generator=gen) for s in sizes]

        draw = {'d_codes': codes(6), 'd_noise': maps(6), 'g_codes': codes(6), 'g_noise': maps(6)}
        if step == 2:
            draw.update(path_codes=codes(3), path_noise=maps(3),
                        path_proj=torch.randn((3, 3, 16, 16), generator=gen) * 3)
        draws.append(draw)
    torch.save(batches, tmp / 'sg2_batches.pt')
    torch.save(draws, tmp / 'sg2_draws.pt')
    return opt, batches, draws


def joint_inputs(tmp):
    """A ``.pth`` of the joint network (non-zero: the UNet's zero-initialised
    convolutions would hide everything upstream) and two global L2S batches
    of 4 with their timesteps and noise."""
    torch.manual_seed(0)
    opt = copy.deepcopy(JOINT)
    net = _nonzero_(build_network(dict(opt['network_g'])), 11)
    torch.save({'params': net.state_dict()}, tmp / 'joint_g.pth')
    opt['path']['pretrain_network_g'] = str(tmp / 'joint_g.pth')
    rng = np.random.RandomState(6)

    def img(*shape):
        a = rng.uniform(-1, 1, (4,) + shape).astype(np.float32)
        a[2:] = a[2:] * 0.5 + 0.2
        return torch.from_numpy(a)

    batches = [{'lq': {'rgb': img(3, 8, 8), 'nss': img(3, 8, 8)},
                'gt': {'rgb': img(3, 24, 24), 'nss': img(3, 12, 12)},
                'sample_path': ['a/b/c'] * 4, 'img_name': ['a_b_c'] * 4,
                'tt': torch.from_numpy(rng.randint(0, 3, 4)),
                'noise': torch.from_numpy(rng.randn(4, 6, 24, 24).astype(np.float32))}
               for _ in range(2)]
    torch.save(batches, tmp / 'joint_batches.pt')
    return opt, batches


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dist_sg2_align')
    sg2, sg2_batches, draws = sg2_inputs(tmp)
    joint, joint_batches = joint_inputs(tmp)
    sg2_nets, joint_nets = ['net_g', 'net_d', 'net_g_ema'], ['net_g', 'net_g_ema']
    jobs = []
    for control in (False, 'stats'):
        jobs.append({'kind': 'model', 'name': 'sg2' + ('_control' if control else ''),
                     'opt': sg2, 'batches': str(tmp / 'sg2_batches.pt'), 'nets': sg2_nets,
                     'draws': str(tmp / 'sg2_draws.pt'), 'adam_eps': ADAM_EPS,
                     'control': control})
    for control in (False, 'grads'):
        jobs.append({'kind': 'model', 'name': 'joint' + ('_control' if control else ''),
                     'opt': joint, 'batches': str(tmp / 'joint_batches.pt'),
                     'nets': joint_nets, 'control': control})
    (tmp / 'job.json').write_text(json.dumps(jobs))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torchrun, 2, osp.join(REPO, 'tests', 'torch_dist_worker.py'),
                            str(tmp), str(tmp / 'job.json'))
        one = {'sg2': one_process(sg2, sg2_batches, sg2_nets, draws=draws, eps=ADAM_EPS),
               'joint': one_process(joint, joint_batches, joint_nets)}
        ranks.result()
    return {'one': one, 'two': {job['name']: torch.load(tmp / f'{job["name"]}.pt',
                                                         weights_only=False) for job in jobs},
            'start': {name: torch.load(tmp / f'{name}_g.pth', weights_only=True)['params']
                      for name in ('sg2', 'joint')}}


def state_misses(got, want):
    return [f'{label} {key}' for label, state in want['states'].items()
            for key, value in state.items()
            if not states_close({0: {0: got['states'][label][key]}}, {0: {0: value}},
                                **F32_ROUNDING)]


def grad_misses(got, want):
    """The gradients an optimizer was handed beyond ``GRAD_TOL`` of the
    network's largest, at each step."""
    out = []
    for step, (g, w) in enumerate(zip(got['grads'], want['grads'])):
        assert g.keys() == w.keys()
        for net in ('net_g', 'net_d'):
            keys = [k for k in w if k.startswith(net)]
            biggest = max(w[k].abs().max().item() for k in keys)
            out += [f'step {step} {k}' for k in keys
                    if (g[k] - w[k]).abs().max().item() > GRAD_TOL * biggest]
    return out


def test_stylegan2_gradients_on_two_ranks_are_one_process(runs):
    """Both steps' gradients of both networks (the second step's with R1's
    and the path length's), and the path batch split 2 + 1."""
    got, want = runs['two']['sg2'], runs['one']['sg2']
    assert len(got['grads']) == 2 and all(len(g) for g in got['grads'])
    assert grad_misses(got, want) == []


def test_stylegan2_on_two_ranks_trains_as_one_process(runs):
    """G, D and the EMA after the two steps, and ``mean_path_length`` (the
    same on every rank, as every weight is)."""
    got, want = runs['two']['sg2'], runs['one']['sg2']
    assert got['same_on_ranks']
    assert state_misses(got, want) == []
    assert got['mean_path_length'] == pytest.approx(want['mean_path_length'], rel=1e-5)
    assert want['mean_path_length'] > 0


@pytest.mark.parametrize('name', ['sg2', 'joint'])
def test_two_ranks_log_one_process_losses(runs, name):
    got, want = runs['two'][name]['losses'], runs['one'][name]['losses']
    assert [list(s) for s in got] == [list(s) for s in want]
    if name == 'sg2':
        assert got[1]['l_d_r1'] > 0 and got[1]['l_g_path'] > 0   # both regularised
    for g, w in zip(got, want):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-4, abs=1e-7), key


def test_stylegan2_with_each_ranks_own_means_fails(runs):
    """The control: R1's and the path length's means over each rank's rows
    (2 and 1 path rows): other gradients, another running mean."""
    control, want = runs['two']['sg2_control'], runs['one']['sg2']
    assert grad_misses(control, want)
    assert control['mean_path_length'] != pytest.approx(want['mean_path_length'], rel=1e-5)


def test_joint_align_model_on_two_ranks_trains_as_one_process(runs):
    """The joint network (UNet, align autoencoder, LR encoder) and its EMA
    after 2 steps, the same on both ranks, and moved."""
    got, want = runs['two']['joint'], runs['one']['joint']
    assert got['same_on_ranks']
    assert state_misses(got, want) == []
    start = runs['start']['joint']
    assert any(not torch.equal(v, start[k]) for k, v in got['states']['net_g'].items())


def test_joint_align_model_without_the_exchange_fails(runs):
    """The control: each rank steps on its own rows' gradients."""
    assert state_misses(runs['two']['joint_control'], runs['one']['joint'])
