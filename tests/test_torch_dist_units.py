"""The port's data-parallel layer piece by piece, in this process: joining
the group from a launcher's environment (and refusing to run without one),
the ``num_gpu`` rule under a launcher, the mesh's axis check, the wrappers'
check that a launch goes to the card the thread is set to, gradients in
their parameters' strides, and the models that refuse to train on several
ranks. The runs on two ranks are in ``test_torch_dist_train.py`` and
``test_torch_dist_models.py``."""

import argparse
import socket
from os import path as osp
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.ops import _launch
from basicsr4rs_torch.parallel import create_mesh, replicate, shard_batch
from basicsr4rs_torch.utils import dist_util
from basicsr4rs_torch.utils.options import parse_options, resolve_num_gpu

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
    (None, 4, (4, 1)), ({'data': -1, 'spatial': 1}, 2, (2, 1)), ({'data': 8}, 8, (8, 1))])
def test_create_mesh_puts_every_rank_on_the_data_axis(parallel, world_size, want):
    assert create_mesh({'parallel': parallel} if parallel else {}, world_size) == want


@pytest.mark.parametrize('parallel, error', [({'data': 2}, ValueError),
                                             ({'data': 3, 'spatial': 1}, ValueError),
                                             ({'spatial': 2}, NotImplementedError),
                                             ({'data': 2, 'spatial': 2}, NotImplementedError)])
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


# ------------------------------------------------- models that do not train
SINGLE_RANK = {
    'SRGANModel': 'GAN models', 'ESRGANModel': 'GAN models', 'RealESRGANModel': 'GAN models',
    'HiFaceGANModel': 'GAN models', 'VideoRecurrentGANModel': 'GAN models',
    'VideoGANModel': 'GAN models', 'StyleGAN2Model': 'StyleGAN2', 'TamingModel': 'TamingModel',
    'AlignSingleModel': 'align models', 'RegistrationModel': 'align models',
    'AlignFrozenDiffModel': 'align models', 'AlignJointDiffModel': 'align models'}


@pytest.mark.parametrize('model_type', list(SINGLE_RANK))
def test_models_without_a_data_parallel_step_raise_on_two_ranks(model_type):
    opt = {'model_type': model_type, 'is_train': True, 'dist': True, 'rank': 0,
           'world_size': 2, 'num_gpu': 0}
    with pytest.raises(NotImplementedError, match=f'{SINGLE_RANK[model_type]}.*ROADMAP'):
        build_model(opt)


@pytest.mark.parametrize('network_g', [{'type': 'DUF', 'num_layer': 16},
                                       {'type': 'TOFlow', 'adapt_official_weights': False}],
                         ids=['DUF', 'TOFlow'])
def test_a_network_that_trains_batchnorm_raises_on_two_ranks(network_g):
    """Per-rank batch statistics would be another function than the JAX
    mesh's global-batch ones: the model raises before it trains."""
    opt = {'model_type': 'VideoBaseModel', 'is_train': True, 'dist': True, 'rank': 0,
           'world_size': 2, 'num_gpu': 0, 'network_g': network_g, 'path': {},
           'train': {'optim_g': {'type': 'Adam', 'lr': 1e-4},
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0}}}
    with pytest.raises(NotImplementedError, match='BatchNorm'):
        build_model(opt)
