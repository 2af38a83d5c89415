"""The port's data-parallel layer piece by piece, in this process: joining
the group from a launcher's environment (and refusing to run without one),
the ``num_gpu`` rule under a launcher, the mesh's axis check, the wrappers'
check that a launch goes to the card the thread is set to, gradients in
their parameters' strides; then every model type built on two gloo ranks
(one torchrun of ``tests/torch_dist_worker.py``), set up for data
parallelism. The training runs on two ranks are in
``test_torch_dist_train.py``, ``test_torch_dist_models.py`` and the
``test_torch_dist_*`` files of the GAN, StyleGAN2 and align models."""

import argparse
import json
import socket
from os import path as osp
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from basicsr4rs_torch.ops import _launch
from basicsr4rs_torch.parallel import create_mesh, replicate, shard_batch
from basicsr4rs_torch.utils import dist_util
from basicsr4rs_torch.utils.options import parse_options, resolve_num_gpu, yaml_load
from basicsr4rs_torch.utils.registry import MODEL_REGISTRY

from torch_dist_worker import torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
CONFIG = osp.join(REPO, 'options', 'train', 'SwinIR', 'train_SwinIR_M_x4_synthetic.yml')
LAUNCH_VARS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT', 'SLURM_PROCID',
               'SLURM_NTASKS', 'SLURM_NODELIST')


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture
def env(monkeypatch):
    """No launcher's variables (and none left behind: ``init_dist('slurm')``
    writes some), and the group left when the test ends."""
    for key in LAUNCH_VARS:
        monkeypatch.setenv(key, '')   # recorded, so that teardown restores it
        monkeypatch.delenv(key)
    yield monkeypatch
    dist_util.close_dist()


def one_rank_env(env):
    for key, value in dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
                           MASTER_PORT=str(free_port())).items():
        env.setenv(key, value)


# -------------------------------------------------------------- init_dist
@pytest.mark.parametrize('launcher', ['pytorch', 'jax'])
def test_init_dist_joins_from_torchruns_environment(env, launcher):
    one_rank_env(env)
    dist_util.init_dist(launcher, 'gloo', use_cuda=False)
    assert dist.is_initialized() and dist.get_backend() == 'gloo'
    assert dist_util.get_dist_info() == (0, 1)
    dist_util.init_dist(launcher, 'gloo', use_cuda=False)   # a second pipeline stays in it
    np.testing.assert_array_equal(dist_util.sum_across_processes(np.arange(3.)), np.arange(3.))
    dist_util.barrier()
    dist_util.close_dist()
    assert not dist.is_initialized() and dist_util.get_dist_info() == (0, 1)


def test_init_dist_reads_slurms_environment(env):
    env.setenv('SLURM_PROCID', '0')
    env.setenv('SLURM_NTASKS', '1')
    env.setenv('SLURM_NODELIST', 'node[0-3]')
    env.setenv('MASTER_PORT', str(free_port()))
    env.setattr(dist_util.subprocess, 'getoutput', lambda cmd: '127.0.0.1')
    dist_util.init_dist('slurm', 'gloo', use_cuda=False)
    assert dist_util.get_dist_info() == (0, 1)
    assert (dist_util.os.environ['RANK'], dist_util.os.environ['WORLD_SIZE'],
            dist_util.os.environ['MASTER_ADDR']) == ('0', '1', '127.0.0.1')


@pytest.mark.parametrize('launcher, missing', [('pytorch', 'RANK'), ('pytorch', 'MASTER_PORT'),
                                               ('jax', 'WORLD_SIZE'), ('slurm', 'SLURM_PROCID')])
def test_a_named_launcher_without_its_environment_raises(env, launcher, missing):
    """No silent single process: the JAX package's ``init_dist`` swallows
    this error, the port's raises it."""
    one_rank_env(env)
    env.setenv('SLURM_PROCID', '0')
    env.setenv('SLURM_NTASKS', '1')
    env.setenv('SLURM_NODELIST', 'node0')
    env.delenv(missing)
    with pytest.raises(RuntimeError, match=missing):
        dist_util.init_dist(launcher, 'gloo', use_cuda=False)
    assert not dist.is_initialized()


def test_init_dist_refuses_nccl_without_a_card_and_an_unknown_launcher(env):
    one_rank_env(env)
    with pytest.raises(RuntimeError, match='nccl needs a CUDA device'):
        dist_util.init_dist('pytorch', 'nccl', use_cuda=False)
    with pytest.raises(ValueError, match='launcher'):
        dist_util.init_dist('mpi', 'gloo', use_cuda=False)
    if not torch.cuda.is_available():   # a rank that asks for a card and has none
        with pytest.raises(RuntimeError, match='CUDA'):
            dist_util.init_dist('pytorch', 'gloo', use_cuda=True)
    assert not dist.is_initialized()


def test_the_command_line_without_torchrun_raises(env):
    args = argparse.Namespace(opt=CONFIG, launcher='pytorch', force_yml=['num_gpu=0'],
                              debug=False, auto_resume=False)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        parse_options(REPO, is_train=True, args=args)


# ----------------------------------------------------------- the options
def _parse(tmp_path, launcher, *force, backend='nccl'):
    config = tmp_path / 'config.yml'
    config.write_text(Path(CONFIG).read_text() + f'\ndist_params:\n  backend: {backend}\n')
    args = argparse.Namespace(opt=str(config), launcher=launcher, debug=False, auto_resume=False,
                              force_yml=[f'path:experiments_root={tmp_path}', *force])
    return parse_options(str(tmp_path), is_train=True, args=args)[0]


@pytest.mark.parametrize('backend', ['nccl', 'gloo'])
def test_options_under_a_launcher(env, tmp_path, backend):
    """``dist`` set, rank and size from the group, the backend gloo under
    ``num_gpu: 0`` whatever ``dist_params`` names, the seed offset by rank."""
    one_rank_env(env)
    opt = _parse(tmp_path, 'pytorch', 'num_gpu=0', 'manual_seed=5', backend=backend)
    assert (opt['dist'], opt['rank'], opt['world_size'], opt['num_gpu']) == (True, 0, 1, 0)
    assert dist.get_backend() == 'gloo' and opt['manual_seed'] == 5
    one = _parse(tmp_path, 'none', 'num_gpu=0')
    assert (one['dist'], one['rank'], one['world_size']) == (False, 0, 1)


@pytest.mark.parametrize('num_gpu, cards, want', [
    (0, 0, 0), (0, 8, 0), (1, 1, 1), (8, 1, 1), ('auto', 8, 1), (8, 8, 1)])
def test_num_gpu_under_a_launcher_is_one_card_a_rank(monkeypatch, num_gpu, cards, want):
    """The published ``num_gpu: 8`` on a card of its own per rank; the
    world size carries the count."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    assert resolve_num_gpu(num_gpu, dist=True) == want


@pytest.mark.parametrize('num_gpu', [2, 8, 'auto'])
def test_more_than_one_card_in_one_process_raises_and_names_torchrun(monkeypatch, num_gpu):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)
    with pytest.raises(RuntimeError, match='--nproc_per_node 8' if num_gpu != 2
                       else '--nproc_per_node 2'):
        resolve_num_gpu(num_gpu)
    assert resolve_num_gpu(1) == 1 and resolve_num_gpu(0) == 0


def test_a_launcher_that_asks_for_a_card_on_a_host_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='num_gpu: 0'):
        resolve_num_gpu('auto', dist=True)


# --------------------------------------------------------------- the mesh
@pytest.mark.parametrize('parallel, world_size, want', [
    (None, 4, (4, 1)), ({'data': -1, 'spatial': 1}, 2, (2, 1)), ({'data': 8}, 8, (8, 1)),
    ({'spatial': 2}, 4, (2, 2)), ({'data': 2, 'spatial': 2}, 4, (2, 2))])
def test_create_mesh_puts_every_rank_on_the_data_axis(parallel, world_size, want):
    assert create_mesh({'parallel': parallel} if parallel else {}, world_size) == want


@pytest.mark.parametrize('parallel, error', [({'data': 2}, ValueError),
                                             ({'data': 3, 'spatial': 1}, ValueError),
                                             ({'data': 3, 'spatial': 2}, ValueError)])
def test_create_mesh_checks_its_axes(parallel, error):
    with pytest.raises(error):
        create_mesh({'parallel': parallel}, 4)


def test_shard_batch_moves_tensors_and_keeps_paths():
    batch = {'lq': torch.zeros(2, 3), 'lq_path': ['a.png', 'b.png']}
    out = shard_batch(batch, torch.device('cpu'))
    assert out['lq'].device.type == 'cpu' and out['lq_path'] == ['a.png', 'b.png']


def test_replicate_and_the_bare_model_keep_bare_names(env, tmp_path):
    """DDP over one gloo rank: the wrapper's names gain ``module.``, the
    model saves and loads through the bare network."""
    one_rank_env(env)
    dist_util.init_dist('pytorch', 'gloo', use_cuda=False)
    net = torch.nn.Sequential(torch.nn.Linear(3, 2))
    wrapped = replicate(net, torch.device('cpu'))
    assert next(iter(wrapped.state_dict())).startswith('module.')
    from basicsr4rs_torch.models.base_model import BaseModel
    model = BaseModel({'is_train': True, 'num_gpu': 0, 'dist': True, 'rank': 0, 'world_size': 1,
                       'path': {'models': str(tmp_path)}})
    assert model.get_bare_model(wrapped) is net and model.get_bare_model(net) is net
    model.save_network(wrapped, 'g', 1)
    saved = torch.load(tmp_path / 'net_g_1.pth', weights_only=True)['params']
    assert list(saved) == ['0.weight', '0.bias']
    fresh = torch.nn.Sequential(torch.nn.Linear(3, 2))
    model.load_network(replicate(fresh, torch.device('cpu')), str(tmp_path / 'net_g_1.pth'))
    assert torch.equal(fresh[0].weight, net[0].weight)


# --------------------------------------------------------- the kernels' side
def test_a_launch_checks_the_current_device(monkeypatch):
    """A ctypes launch runs on the thread's current card: operands on
    another card raise before the launch."""
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(_launch, '_RAW_STREAM', lambda index: 1000 + index)
    assert _launch.current_stream(torch.device('cuda', 0)) == 1000
    assert _launch.current_stream(torch.device('cuda')) == 1000
    with pytest.raises(RuntimeError, match='current device is cuda:0'):
        _launch.current_stream(torch.device('cuda', 1))
    on_card_1 = type('T', (), {'device': torch.device('cuda', 1)})()
    with pytest.raises(RuntimeError, match='set_device'):
        _launch.stream_of(on_card_1)


def test_parameter_gradients_come_back_in_the_parameters_strides():
    """What DDP's buckets expect: a gradient of other strides is copied into
    the parameter's layout, one of the same strides is handed on."""
    p = torch.nn.Parameter(torch.zeros(4, 6))
    flat = torch.arange(48.)
    g = flat[:24].view(4, 6)
    assert _launch.grad_like(g, p) is g
    t = flat[:24].view(6, 4).t()
    got = _launch.grad_like(t, p)
    assert got.stride() == p.stride() and torch.equal(got, t)
    got = _launch.grad_like(g.double(), p)
    assert got.dtype == torch.float32 and got.stride() == p.stride()


# --------------------------------------- every model set up on two ranks
SGD = {'type': 'SGD', 'lr': 0.01}
L1 = {'type': 'L1Loss', 'loss_weight': 1.0}
GAN = {'type': 'GANLoss', 'gan_type': 'vanilla', 'loss_weight': 0.1}
VGG_D = {'type': 'VGGStyleDiscriminator', 'num_in_ch': 3, 'num_feat': 4}
AE = {'num_in_ch': 12, 'num_out_ch': 6, 'num_feat': 8, 'num_block': 1}
UNET = {'image_size': 24, 'in_channels': 6, 'model_channels': 32, 'out_channels': 6,
        'num_res_blocks': 1, 'attention_resolutions': [], 'channel_mult': [1],
        'num_head_channels': 16, 'swin_embed_dim': 32, 'window_size': 4, 'mlp_ratio': 2,
        'cond_lq': True, 'lq_size': 24}
DIFFUSION = {'normalize_input': True, 'schedule_name': 'exponential', 'sf': 3,
             'min_noise_level': 0.2, 'steps': 3, 'kappa': 2.0, 'etas_end': 0.99,
             'schedule_kwargs': {'power': 0.3}, 'predict_type': 'xstart',
             'timestep_respacing': None, 'latent_flag': False}


def _opt(model_type, network_g, train, **top):
    return {'name': 'build', 'model_type': model_type, 'scale': 4, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'network_g': network_g,
            'path': {'strict_load_g': True}, 'val': {'val_freq': 100},
            'train': {'optim_g': dict(SGD), **train}, **top}


def _gan(model_type, network_g, network_d=VGG_D, **train):
    return _opt(model_type, network_g, {'optim_d': dict(SGD), 'pixel_opt': dict(L1),
                                        'gan_opt': dict(GAN), 'ema_decay': 0.9, **train},
                network_d=dict(network_d))


def _realesrgan():
    opt = yaml_load(osp.join(REPO, 'options', 'train', 'RealESRGAN',
                             'train_realesrgan_x4plus_synthetic.yml'))
    for key in ('datasets', 'logger', 'dist_params', 'path'):
        opt.pop(key, None)
    opt['train'].pop('perceptual_opt')
    opt['train'].update(optim_g=dict(SGD), optim_d=dict(SGD))
    opt.update(num_gpu=0, is_train=True, queue_size=4, gt_size=32, path={},
               network_g={'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3, 'num_feat': 8,
                          'num_block': 1, 'num_grow_ch': 4},
               network_d={'type': 'UNetDiscriminatorSN', 'num_in_ch': 3, 'num_feat': 4})
    return opt


def _hifacegan():
    opt = yaml_load(osp.join(REPO, 'options', 'train', 'HiFaceGAN', 'train_hifacegan.yml'))
    for key in ('datasets', 'logger', 'dist_params'):
        opt.pop(key, None)
    opt['train'].pop('perceptual_opt')
    opt['train'].update(optim_g=dict(SGD), optim_d=dict(SGD), pixel_opt=dict(L1))
    opt['network_g'].update(num_feat=4, crop_size=64)
    opt['network_d'].update(num_feat=4)
    opt.update(num_gpu=0, is_train=True, path={})
    return opt


def _video(network_g):
    return _opt('VideoBaseModel', network_g, {'pixel_opt': dict(L1)})


ALIGN_STAGES = {'stage1_opt': {'type': 'MSELoss', 'loss_weight': 0.25},
                'stage2_opt': {'type': 'MSELoss', 'loss_weight': 1.0}}
BUILT = {
    'SRGANModel': _gan('SRGANModel', {'type': 'MSRResNet', 'num_feat': 8, 'num_block': 1}),
    'ESRGANModel': _gan('ESRGANModel', {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3,
                                        'num_feat': 8, 'num_block': 1, 'num_grow_ch': 4}),
    'RealESRGANModel': _realesrgan(),
    'HiFaceGANModel': _hifacegan(),
    'VideoRecurrentGANModel': _gan('VideoRecurrentGANModel',
                                   {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1},
                                   dict(VGG_D, input_size=256)),
    'VideoGANModel': _gan('VideoGANModel', {'type': 'EDVR', 'num_feat': 8, 'num_frame': 3,
                                            'deformable_groups': 2, 'num_extract_block': 1,
                                            'num_reconstruct_block': 1, 'hr_in': False,
                                            'with_tsa': False}),
    'StyleGAN2Model': _opt(
        'StyleGAN2Model', {'type': 'StyleGAN2Generator', 'out_size': 16, 'num_style_feat': 8,
                           'num_mlp': 2, 'channel_multiplier': 1, 'narrow': 0.25},
        {'optim_g': {'type': 'Adam', 'lr': 2e-3}, 'optim_d': {'type': 'Adam', 'lr': 2e-3},
         'r1_reg_weight': 10, 'path_reg_weight': 2, 'net_g_reg_every': 2, 'net_d_reg_every': 2,
         'mixing_prob': 0.5, 'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus'}},
        network_d={'type': 'StyleGAN2Discriminator', 'out_size': 16, 'channel_multiplier': 1,
                   'narrow': 0.25, 'stddev_group': 2}),
    'TamingModel': _opt('TamingModel', {
        'type': 'VQModelTorch', 'embed_dim': 4, 'n_embed': 16,
        'ddconfig': {'attn_resolutions': [], 'ch': 32, 'ch_mult': [1, 2], 'double_z': False,
                     'dropout': 0.0, 'in_channels': 4, 'num_res_blocks': 1, 'out_ch': 4,
                     'resolution': 16, 'z_channels': 4}}, {'pixel_opt': dict(L1)}),
    'AlignSingleModel': _opt('AlignSingleModel', {'type': 'StyleResNet', **AE}, ALIGN_STAGES,
                             scale=3),
    'RegistrationModel': _opt('RegistrationModel', {'type': 'StyleResNet', **AE}, ALIGN_STAGES,
                              scale=3),
    'AlignFrozenDiffModel': _opt(
        'AlignFrozenDiffModel', {'type': 'UNetModelSwin', 'lq_channels': 6, **UNET}, {},
        scale=3, autoencoder={'type': 'AlignAutoencoder', **AE}, diffusion=DIFFUSION),
    'AlignJointDiffModel': _opt(
        'AlignJointDiffModel', {'type': 'ResNetAE_SwinUNet', 'unet_args': UNET,
                                'align_autoencoder_args': AE,
                                'lr_encoder_args': {'num_in_ch': 6, 'num_out_ch': 6,
                                                    'num_feat': 8, 'num_block': 1}},
        {'diffusion_opt': {'type': 'MSELoss', 'loss_weight': 1.0}}, scale=3,
        diffusion=DIFFUSION),
    'DUF': _video({'type': 'DUF', 'num_layer': 16}),
    'TOFlow': _video({'type': 'TOFlow', 'adapt_official_weights': False}),
}
# the networks each trains, and whether the model wraps them in DDP
TRAINED = {'StyleGAN2Model': ('net_g', 'net_d'), 'TamingModel': ('net_g',),
           'AlignSingleModel': ('net_g',), 'RegistrationModel': ('net_g',),
           'AlignFrozenDiffModel': ('net_g',), 'AlignJointDiffModel': ('net_g',),
           'DUF': ('net_g',), 'TOFlow': ('net_g',)}
WRAPPED = ('AlignSingleModel', 'RegistrationModel', 'AlignFrozenDiffModel', 'DUF', 'TOFlow')
# the modules that take the global batch's statistics (sync_ranks), by
# network: BatchNorm, SPADE's and the PatchGAN's norms, StyleGAN2's
# minibatch stddev
SYNCED = {'SRGANModel': {'net_d': 9}, 'ESRGANModel': {'net_d': 9},
          'VideoRecurrentGANModel': {'net_d': 11}, 'VideoGANModel': {'net_d': 9},
          'HiFaceGANModel': {'net_g': 18, 'net_d': 2}, 'DUF': {'net_g': 13},
          'TOFlow': {'net_g': 16}, 'StyleGAN2Model': {'net_d': 1}}


def _batches():
    """A global batch for each model of ``BUILT``, 2 or more rows a rank."""
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    def l2s(**extra):
        return {'lq': {'rgb': t(4, 3, 8, 8), 'nss': t(4, 3, 8, 8)},
                'gt': {'rgb': t(4, 3, 24, 24), 'nss': t(4, 3, 12, 12)},
                'sample_path': ['a/b/c'] * 4, 'img_name': ['a_b_c'] * 4, **extra}

    latent = {'tt': torch.from_numpy(rng.randint(0, 3, 4)), 'noise': t(4, 6, 24, 24) - 0.5}
    sr = {'lq': t(4, 3, 32, 32), 'gt': t(4, 3, 128, 128)}
    return {'SRGANModel': sr, 'ESRGANModel': sr,
            'RealESRGANModel': {'lq': t(4, 3, 8, 8), 'gt': t(4, 3, 32, 32)},
            'HiFaceGANModel': {'lq': t(2, 3, 64, 64), 'gt': t(2, 3, 64, 64)},
            'VideoRecurrentGANModel': {'lq': t(2, 3, 3, 64, 64), 'gt': t(2, 3, 3, 256, 256)},
            'VideoGANModel': {'lq': t(4, 3, 3, 32, 32), 'gt': t(4, 3, 128, 128)},
            'StyleGAN2Model': {'gt': t(4, 3, 16, 16) * 2 - 1},
            'TamingModel': {'gt': t(4, 4, 16, 16)},
            'AlignSingleModel': l2s(), 'RegistrationModel': l2s(),
            'AlignFrozenDiffModel': l2s(**latent), 'AlignJointDiffModel': l2s(**latent),
            'DUF': {'lq': t(4, 7, 3, 16, 16), 'gt': t(4, 3, 64, 64)},
            'TOFlow': {'lq': t(2, 7, 3, 64, 64), 'gt': t(2, 3, 64, 64)}}


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    """Every model of ``BUILT`` built on two gloo ranks through torchrun,
    each rank from its own random weights, and stepped once."""
    tmp = tmp_path_factory.mktemp('built')
    torch.save(_batches(), tmp / 'batches.pt')
    job = tmp / 'job.json'
    job.write_text(json.dumps([{'kind': 'build', 'name': 'built', 'opts': BUILT,
                                'batches': str(tmp / 'batches.pt')}]))
    torchrun(2, osp.join(REPO, 'tests', 'torch_dist_worker.py'), str(tmp), str(job))
    return torch.load(tmp / 'built.pt', weights_only=True)


def _check_built(got, label):
    nets = TRAINED.get(label, ('net_g', 'net_d'))
    assert tuple(got['nets']) == nets
    want_type = 'DistributedDataParallel' if label in WRAPPED else None
    for name in nets:
        if want_type:
            assert got['nets'][name] == want_type, name
        else:   # bare, its gradients averaged before each optimizer step
            assert got['nets'][name] != 'DistributedDataParallel', name
        flags = got['synced'][name]
        assert len(flags) == SYNCED.get(label, {}).get(name, 0) and all(flags), (name, flags)
    assert got['losses'] and all(np.isfinite(v) for v in got['losses'].values())
    assert got['same_on_ranks']   # rank 0's weights, buffers and EMA on both, after a step


@pytest.mark.parametrize('model_type', [k for k in BUILT if k not in ('DUF', 'TOFlow')])
def test_models_without_a_data_parallel_step_raise_on_two_ranks(built, model_type):
    """Each of the twelve model types that used to raise on more than one
    rank builds on two: its trained networks wrapped in DDP or left bare
    for the flat exchange, their BatchNorm and SPADE ``batch`` norms and
    StyleGAN2's minibatch stddev synced; after one step on each rank's rows
    the losses are finite and every rank holds the same weights."""
    assert built[model_type]['model'] == MODEL_REGISTRY.get(model_type).__name__
    _check_built(built[model_type], model_type)


@pytest.mark.parametrize('network_g', ['DUF', 'TOFlow'])
def test_a_network_that_trains_batchnorm_raises_on_two_ranks(built, network_g):
    """A network that trains BatchNorm builds on two ranks under DDP, each
    of its norms taking the global batch's statistics (Flax's over the JAX
    mesh): the generator's 13 (DUF) or 16 (TOFlow's SpyNet) norms synced,
    and after one step both ranks hold the same weights and buffers."""
    assert built[network_g]['model'] == 'VideoBaseModel'
    _check_built(built[network_g], network_g)
