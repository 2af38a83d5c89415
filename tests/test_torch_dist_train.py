"""Data-parallel training of the port on two gloo ranks, started as a user
starts it: ``python -m torch.distributed.run --standalone --nproc_per_node 2
-m basicsr4rs_torch.train -opt <yml> --launcher pytorch``.

A small SwinIR (2 RSTBs of 2 blocks at width 24, window 8, no DropPath)
trains 2 steps of SGD on 8 pairs whose GT is the crop size, without flips or
rotations, so that no random draw touches the data. Each rank takes 2 rows a
step (``EnlargedSampler`` strides the permutation by rank), and the two
ranks together take the rows one process takes at batch 4. The run is held
against one port process at batch 4 and against the JAX package's
``SwinIRModel`` on its 8-device CPU mesh fed the same global batches. Then
the two ranks resume from the saved state up to iteration 4.

SGD, because Adam divides by the gradient's size and so turns the rounding
of entries whose gradient is noise (the key bias) into a step of the full
rate in either direction; the SGD trajectory is held to float32 rounding."""

import contextlib
import json
import logging
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from os import path as osp
from unittest import mock

import cv2
import numpy as np
import pytest
import torch
import yaml

import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.models.swinir_model import SwinIRModel
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.models import build_model as jax_build_model

from test_torch_swinir_train import grads_to_state_dict
from torch_dist_worker import torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
CONFIG = osp.join(REPO, 'options', 'train', 'SwinIR', 'train_SwinIR_M_x4_synthetic.yml')
NAME = 'train_SwinIR_M_x4_synthetic'
SHRINK = dict(depths=[2, 2], num_heads=[2, 2], embed_dim=24, img_size=8, drop_path_rate=0.0)
LR, EMA_DECAY, STEPS = 1e-2, 0.9, 2
# float32 sums of the same terms taken in another order (the gradient
# all-reduce, the batch split in two): parameters and EMA after 2 steps
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)


def write_config(root, batch, exp_root):
    """The synthetic SwinIR-M config cut to size, on ``root``'s pairs."""
    opt = json.loads(json.dumps(yaml_load(CONFIG)))
    opt['num_gpu'] = 0
    opt['dist_params'] = {'backend': 'nccl'}   # gloo under num_gpu: 0
    train = opt['datasets']['train']
    train.update(dataroot_gt=str(root / 'GT'), dataroot_lq=str(root / 'LQ'), gt_size=32,
                 use_hflip=False, use_rot=False, num_worker_per_gpu=0, batch_size_per_gpu=batch)
    opt['datasets']['val'].update(dataroot_gt=str(root / 'val_GT'),
                                  dataroot_lq=str(root / 'val_LQ'))
    opt['network_g'].update(SHRINK)
    opt['path'].update(pretrain_network_g=str(root / 'init.pth'), experiments_root=str(exp_root))
    opt['train'].update(ema_decay=EMA_DECAY, total_iter=STEPS, optim_g={'type': 'SGD', 'lr': LR},
                        scheduler={'type': 'MultiStepLR', 'milestones': [2], 'gamma': 0.5})
    opt['val']['val_freq'] = 2
    opt['logger'].update(print_freq=1, save_checkpoint_freq=2)
    path = root / f'config_b{batch}.yml'
    path.write_text(yaml.safe_dump(opt, sort_keys=False))
    return str(path)


def logged_steps(log_dir):
    """(iteration, rate, l_pix) of every step line of the training logs."""
    steps = []
    for log in sorted(log_dir.glob('train_*.log')):
        for m in re.finditer(r'iter:\s*([\d,]+), lr:\(([\d.e+-]+),\)\].*?l_pix: ([\d.e+-]+)',
                             log.read_text()):
            steps.append((int(m[1].replace(',', '')), float(m[2]), float(m[3])))
    return steps


@contextlib.contextmanager
def own_log_file():
    """The port's logger without the file an earlier test in this process
    gave it, so that a pipeline run here writes its own ``train_*.log``;
    the earlier handlers are back afterwards."""
    logger = logging.getLogger('basicsr4rs_torch')
    saved = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    for handler in saved:
        logger.removeHandler(handler)
    try:
        yield
    finally:
        for handler in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(handler)
            handler.close()
        for handler in saved:
            logger.addHandler(handler)


def one_process_and_jax(root):
    """The one process at the global batch (its fed batches recorded), then
    the JAX package's ``SwinIRModel`` from ``init.pth`` fed those batches."""
    fed, losses = [], []
    step = SwinIRModel.optimize_parameters

    def recorded(model, current_iter):
        fed.append((model.lq.numpy().copy(), model.gt.numpy().copy()))
        step(model, current_iter)
        losses.append(model.get_current_log()['l_pix'])

    argv = sys.argv
    sys.argv = ['train.py', '-opt', write_config(root, 4, root / 'one')]
    try:
        with mock.patch.object(SwinIRModel, 'optimize_parameters', recorded), own_log_file():
            port_train.train_pipeline(str(root))
    finally:
        sys.argv = argv

    opt = yaml_load(CONFIG)
    opt.update(num_gpu=0, is_train=True, dist=False, rank=0, world_size=1, manual_seed=0)
    opt['network_g'].update(SHRINK)
    opt['path'] = {'pretrain_network_g': str(root / 'init.pth'), 'strict_load_g': True}
    opt['train'].update(ema_decay=EMA_DECAY, optim_g={'type': 'SGD', 'lr': LR},
                        scheduler={'type': 'MultiStepLR', 'milestones': [2], 'gamma': 0.5})
    jax_model = jax_build_model(opt)
    jax_losses = []
    for current_iter, (lq, gt) in enumerate(fed, 1):
        jax_model.feed_data({'lq': lq.transpose(0, 2, 3, 1), 'gt': gt.transpose(0, 2, 3, 1)})
        jax_model.optimize_parameters(current_iter)
        jax_losses.append(jax_model.get_current_log()['l_pix'])
    return fed, losses, jax_model, jax_losses


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two-rank run and its resume to iteration 4 (in a thread, while
    this process runs the one process and the JAX model), all from one
    ``init.pth``."""
    root = tmp_path_factory.mktemp('dist_train')
    rng = np.random.RandomState(0)
    for gt_dir, lq_dir, count in (('GT', 'LQ', 8), ('val_GT', 'val_LQ', 2)):
        (root / gt_dir).mkdir()
        (root / lq_dir).mkdir()
        for i in range(count):
            gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / gt_dir / f'{i}.png'), gt)
            cv2.imwrite(str(root / lq_dir / f'{i}.png'),
                        cv2.resize(gt, (8, 8), interpolation=cv2.INTER_AREA))
    net_opt = {k: v for k, v in yaml_load(CONFIG)['network_g'].items() if k != 'type'}
    net_opt.update(SHRINK)
    init = SwinIR(**net_opt, generator=torch.Generator().manual_seed(1))
    torch.save({'params': init.state_dict()}, root / 'init.pth')

    config = write_config(root, 2, root / 'two')
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(lambda: [
            torchrun(2, '-m', 'basicsr4rs_torch.train', '-opt', config, '--launcher', 'pytorch'),
            torchrun(2, '-m', 'basicsr4rs_torch.train', '-opt', config, '--launcher', 'pytorch',
                     '--auto_resume', '--force_yml', 'train:total_iter=4')])
        fed, losses, jax_model, jax_losses = one_process_and_jax(root)
        two, resumed = ranks.result()
    return dict(root=root, two=root / 'two' / NAME, resumed_out=resumed,
                fed=fed, losses=losses, init=init, jax=(jax_model, jax_losses))


def test_two_ranks_ran_their_steps_checkpoints_and_validations(runs):
    exp = runs['two']
    assert [s[0] for s in logged_steps(exp)] == [1, 2, 3, 4]   # the run, then the resume
    assert sorted(p.name for p in (exp / 'models').iterdir()) == [
        'net_g_2.pth', 'net_g_4.pth', 'net_g_latest.pth']
    assert sorted(p.name for p in (exp / 'training_states').iterdir()) == ['2.state', '4.state']
    log = next(exp.glob('train_*.log')).read_text()
    assert 'World size (process count): 2' in log and 'Batch size per gpu: 2' in log
    assert 'Validation SwinIR_M_x4_synthetic_val' in log   # rank 0 validated
    assert (exp / 'config_b2.yml').exists()   # the option file, copied by rank 0


def test_global_batch_is_the_ranks_rows_together(runs):
    """Each rank took 2 rows a step and the two ranks 4 between them, the
    4 the one process took: the same iterations an epoch and the same
    losses (the log's 5 digits)."""
    two = [s for s in logged_steps(runs['two']) if s[0] <= STEPS]
    assert [s[0] for s in two] == [1, 2]
    assert all(len(lq) == 4 for lq, _ in runs['fed'])
    np.testing.assert_allclose([s[2] for s in two], runs['losses'], rtol=2e-4)
    one_log = next((runs['root'] / 'one' / NAME).glob('train_*.log')).read_text()
    assert 'Require iter number per epoch: 2' in one_log
    two_log = next(runs['two'].glob('train_*.log')).read_text()
    assert 'Require iter number per epoch: 2' in two_log


@pytest.mark.parametrize('key', ['params', 'params_ema'])
def test_two_ranks_match_one_process_at_the_global_batch(runs, key):
    """``net_g_2.pth`` of the two ranks against the one process's after the
    same 2 steps: float32 rounding (``F32_ROUNDING``), and it moved."""
    got = torch.load(runs['two'] / 'models' / 'net_g_2.pth', weights_only=True)[key]
    want = torch.load(runs['root'] / 'one' / NAME / 'models' / 'net_g_2.pth',
                      weights_only=True)[key]
    assert got.keys() == want.keys()
    assert not any(k.startswith('module.') for k in got)
    for name, value in got.items():
        torch.testing.assert_close(value, want[name], **F32_ROUNDING, msg=name)
    first = 'layers.0.residual_group.blocks.0.attn.qkv.weight'
    assert not torch.equal(got[first], runs['init'].state_dict()[first])


def test_two_ranks_match_the_jax_mesh_at_the_global_batch(runs):
    """Losses: rtol 5e-4, atol 5e-5 (the log's digits within the JAX
    package's bound against torch); parameters and EMA after SGD: atol 1e-5
    + rtol 1e-3 per entry, the bound of ``test_torch_train.py``."""
    model, losses = runs['jax']
    two = [s[2] for s in logged_steps(runs['two']) if s[0] <= STEPS]
    np.testing.assert_allclose(two, losses, rtol=5e-4, atol=5e-5)
    ckpt = torch.load(runs['two'] / 'models' / 'net_g_2.pth', weights_only=True)
    for key, tree in (('params', model.state.params), ('params_ema', model.state.ema_params)):
        want = grads_to_state_dict(tree)
        for name, value in want.items():
            np.testing.assert_allclose(ckpt[key][name].numpy(), value.numpy(), atol=1e-5,
                                       rtol=1e-3, err_msg=f'{key} {name}')


def test_two_rank_pth_loads_in_the_jax_package(runs):
    """The file the two ranks saved, read by the JAX ``SwinIRModel`` for
    testing (``params_ema``), holds exactly the EMA the file has."""
    path = runs['two'] / 'models' / 'net_g_2.pth'
    opt = yaml_load(CONFIG)
    opt.update(num_gpu=1, is_train=False, dist=False, rank=0, world_size=1)
    opt['network_g'].update(SHRINK)
    opt['path'] = {'pretrain_network_g': str(path), 'param_key_g': 'params_ema',
                   'strict_load_g': True}
    opt.pop('train')
    loaded = grads_to_state_dict(jax_build_model(opt).state.params)
    ema = torch.load(path, weights_only=True)['params_ema']
    for name, value in loaded.items():
        np.testing.assert_array_equal(value.numpy(), ema[name].numpy(), err_msg=name)


def test_two_ranks_resume_at_the_saved_iteration(runs):
    """``--auto_resume`` on two ranks: steps 3 and 4 at the halved rate (the
    scheduler came back), each rank's DropPath generator from its own entry
    of the state's ``rank_states``."""
    assert re.search(r'Resuming training from epoch: \d+, iter: 2\.', runs['resumed_out'])
    steps = logged_steps(runs['two'])
    assert [(s[0], s[1]) for s in steps[2:]] == [(3, LR / 2), (4, LR / 2)]
    assert all(np.isfinite(s[2]) for s in steps)
    state = torch.load(runs['two'] / 'training_states' / '2.state', weights_only=True)
    assert len(state['rank_states']) == 2
    gens = [r['drop_path_generator'] for r in state['rank_states']]
    assert not torch.equal(gens[0], gens[1])   # seeded by manual_seed + rank
    assert torch.equal(state['drop_path_generator'], gens[0])
