"""The port's training path (``python -m basicsr4rs_torch.train``) against
the JAX package's, piece by piece and as a whole: losses, learning-rate
schedules, the sampler, crops and flips, 5-step SGD and Adam loss
trajectories and the EMA of a small SwinIR with one shared init, and the
pipeline end to end on a tiny config (checkpoints, training state,
auto-resume, a saved ``.pth`` read back by the JAX package). Everything runs
on the CPU (``num_gpu: 0``), in float32."""

import sys
from os import path as osp
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.data import loader as port_loader
from basicsr4rs_torch.data import transforms as port_transforms
from basicsr4rs_torch.losses import build_loss as port_build_loss
from basicsr4rs_torch.losses import loss_util as port_loss_util
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.base_model import BaseModel
from basicsr4rs_torch.models.swinir_model import SwinIRModel
from basicsr4rs_torch.utils import misc as port_misc
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.data import loader as jax_loader
from basicsr4rs_tpu.data import transforms as jax_transforms
from basicsr4rs_tpu.losses import build_loss as jax_build_loss
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models.lr_scheduler import build_schedule

from test_torch_swinir_train import grads_to_state_dict

CONFIG = osp.join(osp.dirname(__file__), '..', 'options', 'train', 'SwinIR',
                  'train_SwinIR_M_x4_synthetic.yml')


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('weighted', [False, True], ids=['unweighted', 'weighted'])
@pytest.mark.parametrize('loss_type', ['L1Loss', 'MSELoss', 'CharbonnierLoss'])
def test_losses_match_jax(loss_type, weighted, reduction):
    """Value and gradient with respect to the prediction; rtol 1e-5 for
    float32 sums over 2x3x8x10 entries taken in another order."""
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 3, 8, 10).astype(np.float32)
    target = rng.rand(2, 3, 8, 10).astype(np.float32)
    weight = rng.rand(2, 1, 8, 10).astype(np.float32) if weighted else None
    opt = dict(type=loss_type, loss_weight=0.7, reduction=reduction)

    def nhwc(a):
        return None if a is None else jnp.asarray(a.transpose(0, 2, 3, 1))

    jax_loss = jax_build_loss(opt)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_loss(p, nhwc(target), nhwc(weight)).sum())(nhwc(pred))

    p = torch.from_numpy(pred).requires_grad_()
    got = port_build_loss(opt)(p, torch.from_numpy(target),
                               None if weight is None else torch.from_numpy(weight))
    assert got.shape == (() if reduction != 'none' else pred.shape)
    got.sum().backward()
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-7)


def test_build_loss_rejects_what_it_does_not_know():
    with pytest.raises(ValueError, match='reduction'):
        port_build_loss(dict(type='L1Loss', reduction='median'))
    with pytest.raises(ValueError, match='reduction'):
        port_loss_util.reduce_loss(torch.zeros(2), 'median')
    with pytest.raises(KeyError):
        port_build_loss(dict(type='NoSuchLoss'))


# --------------------------------------------------------------- schedulers
SCHEDULERS = {
    'multistep': dict(type='MultiStepLR', milestones=[5, 9, 14], gamma=0.5),
    'multistep_restart': dict(type='MultiStepRestartLR', milestones=[4, 7, 13, 16], gamma=0.5,
                              restarts=[0, 10], restart_weights=[1, 0.5]),
    'cosine_restart': dict(type='CosineAnnealingRestartLR', periods=[6, 8, 6],
                           restart_weights=[1, 0.5, 0.25], eta_min=1e-7),
    'constant': dict(type='ConstantLR'),
}


@pytest.mark.parametrize('warmup_iter', [-1, 4], ids=['no_warmup', 'warmup_4'])
@pytest.mark.parametrize('name', list(SCHEDULERS))
def test_schedulers_match_jax_at_every_iteration(name, warmup_iter):
    """The learning rate that each of 20 iterations trains with, driven as
    the training loop drives it (``update_learning_rate`` before the step),
    against ``build_schedule`` at step ``current_iter - 1``; rtol 1e-5
    (the JAX schedules evaluate in float32, cosines included)."""
    base_lr = 2e-4
    model = BaseModel({'is_train': True, 'num_gpu': 0,
                       'train': {'scheduler': dict(SCHEDULERS[name])}})
    param = torch.nn.Parameter(torch.zeros(3))
    optimizer = model.get_optimizer('Adam', [param], lr=base_lr, betas=(0.9, 0.99))
    model.optimizers.append(optimizer)
    model.setup_schedulers()
    schedule = build_schedule(base_lr, dict(SCHEDULERS[name]), warmup_iter)
    for current_iter in range(1, 21):
        model.update_learning_rate(current_iter, warmup_iter=warmup_iter)
        got = model.get_current_learning_rate()
        assert len(got) == 1
        np.testing.assert_allclose(got[0], float(schedule(current_iter - 1)), rtol=1e-5,
                                   err_msg=f'iteration {current_iter}')
        param.grad = torch.ones(3)
        optimizer.step()


def test_scheduler_and_optimizer_setup_reject_what_they_do_not_know():
    model = BaseModel({'is_train': True, 'num_gpu': 0,
                       'train': {'scheduler': {'type': 'NoSuchLR'}}})
    param = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError, match='optimizer'):
        model.get_optimizer('Adagrad', [param], lr=1e-3)
    model.optimizers.append(model.get_optimizer('SGD', [param], lr=1e-3))
    with pytest.raises(NotImplementedError, match='Scheduler'):
        model.setup_schedulers()


# ------------------------------------------------------ sampler and transforms
@pytest.mark.parametrize('size, replicas, ratio', [(10, 1, 1), (7, 2, 3), (5, 4, 10)])
def test_enlarged_sampler_draws_the_jax_packages_indices(size, replicas, ratio):
    for rank in range(replicas):
        got = port_loader.EnlargedSampler(size, replicas, rank, ratio)
        want = jax_loader.EnlargedSampler(size, replicas, rank, ratio)
        assert len(got) == len(want)
        for epoch in (0, 1, 5):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
            assert len(list(got)) == len(got)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_crop_and_augment_match_jax_with_the_same_generator_seed(seed):
    """The same ``numpy.random.Generator`` seed gives the same crop, flips
    and rotation in both packages, for one image and for lists."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(48, 64, 3).astype(np.float32)
    lq = rng.rand(12, 16, 3).astype(np.float32)
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = port_transforms.paired_random_crop(gt, lq, 32, 4, 'a.png', rng=got_rng)
    want = jax_transforms.paired_random_crop(gt, lq, 32, 4, 'a.png', rng=want_rng)
    assert got[0].shape == (32, 32, 3) and got[1].shape == (8, 8, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got, got_status = port_transforms.augment(list(got), True, True, return_status=True,
                                              rng=got_rng)
    want, want_status = jax_transforms.augment(list(want), True, True, return_status=True,
                                               rng=want_rng)
    assert got_status == want_status
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_rng.random() == want_rng.random()   # both drew the same count
    np.testing.assert_array_equal(port_transforms.mod_crop(gt[:47, :63], 4),
                                  jax_transforms.mod_crop(gt[:47, :63], 4))
    with pytest.raises(ValueError, match='Scale mismatches'):
        port_transforms.paired_random_crop(gt, lq[:11], 32, 4)
    with pytest.raises(ValueError, match='smaller than patch size'):
        port_transforms.paired_random_crop(gt, lq, 128, 4)


# ----------------------------------------------------- training trajectories
NET = dict(type='SwinIR', img_size=8, patch_size=1, in_chans=3, embed_dim=24, depths=[2],
           num_heads=[2], window_size=4, mlp_ratio=2, upscale=2, img_range=1.0,
           upsampler='pixelshuffle', resi_connection='1conv', drop_path_rate=0.0)
OPTIMIZERS = {'SGD': dict(type='SGD', lr=1e-2),
              'Adam': dict(type='Adam', lr=1e-3, weight_decay=0, betas=[0.9, 0.99])}
STEPS, EMA_DECAY = 5, 0.9


def _model_opt(optim, init_path):
    return {'name': 'trajectory', 'model_type': 'SwinIRModel', 'scale': 2, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(NET),
            'path': {'pretrain_network_g': init_path, 'strict_load_g': True},
            'train': {'ema_decay': EMA_DECAY, 'optim_g': dict(OPTIMIZERS[optim]),
                      'scheduler': {'type': 'MultiStepLR', 'milestones': [3], 'gamma': 0.5},
                      'total_iter': 100,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}},
            'val': {'val_freq': 100}}


@pytest.mark.parametrize('optim', list(OPTIMIZERS))
def test_loss_trajectory_and_ema_match_jax(optim, tmp_path):
    """5 steps of the two packages' ``SwinIRModel`` from one ``.pth`` on the
    same batches (one RSTB of 2 blocks, maps of 4x4 windows of 4, the shifted
    block masked, the rate halved after step 3). Losses: rtol 5e-4, atol
    5e-5, the JAX package's own bound for its SGD trajectory against the
    torch reference. EMA after SGD: atol 1e-5 + rtol 1e-3 per entry. Adam
    divides by the gradient's size, so entries whose gradient is rounding
    noise (the key bias, which softmax ignores) move by the rate in either
    direction; its EMA is held to 2 x 5 steps x rate."""
    net_opt = {k: v for k, v in NET.items() if k != 'type'}
    init = SwinIR(**net_opt, generator=torch.Generator().manual_seed(1))
    init_path = str(tmp_path / 'init.pth')
    torch.save({'params': init.state_dict()}, init_path)

    port_model = port_build_model(_model_opt(optim, init_path))
    jax_model = jax_build_model(_model_opt(optim, init_path))
    rng = np.random.RandomState(7)
    port_losses, jax_losses, rates = [], [], []
    for current_iter in range(1, STEPS + 1):
        lq = rng.rand(2, 3, 16, 16).astype(np.float32)
        gt = rng.rand(2, 3, 32, 32).astype(np.float32)
        port_model.update_learning_rate(current_iter)
        port_model.feed_data({'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt)})
        rates.append((port_model.get_current_learning_rate()[0],
                      jax_model.get_current_learning_rate()[0]))
        port_model.optimize_parameters(current_iter)
        port_losses.append(port_model.get_current_log()['l_pix'])
        jax_model.feed_data({'lq': lq.transpose(0, 2, 3, 1), 'gt': gt.transpose(0, 2, 3, 1)})
        jax_model.optimize_parameters(current_iter)
        jax_losses.append(jax_model.get_current_log()['l_pix'])

    np.testing.assert_allclose([r[0] for r in rates], [r[1] for r in rates], rtol=1e-6)
    assert rates[-1][0] == pytest.approx(rates[0][0] / 2)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=5e-4, atol=5e-5)
    assert abs(port_losses[0] - port_losses[-1]) > 1e-4   # it trained

    want_ema = grads_to_state_dict(jax_model.state.ema_params)
    got_ema = dict(port_model.net_g_ema.named_parameters())
    assert got_ema.keys() == want_ema.keys()
    lr = OPTIMIZERS[optim]['lr']
    assert not torch.equal(got_ema['conv_last.weight'], init.state_dict()['conv_last.weight'])
    for key, value in got_ema.items():
        tolerance = dict(atol=1e-5, rtol=1e-3) if optim == 'SGD' else dict(atol=10 * lr, rtol=0)
        np.testing.assert_allclose(value.detach().numpy(), want_ema[key].numpy(), **tolerance,
                                   err_msg=f'EMA of {key}')


def test_model_ema_is_the_lerp():
    model = BaseModel({'is_train': True, 'num_gpu': 0})
    model.net_g = torch.nn.Linear(3, 2)
    model.net_g_ema = torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in model.net_g_ema.parameters()]
    model.model_ema(decay=0.75)
    for p, b, cur in zip(model.net_g_ema.parameters(), before, model.net_g.parameters()):
        torch.testing.assert_close(p, 0.75 * b + 0.25 * cur)


# ------------------------------------------------------------- the pipeline
@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """``train_pipeline`` on the synthetic config cut to 2 RSTBs of 2 blocks
    at width 24, 6 training pairs (GT 64x64) and 2 validation pairs, 8
    iterations with validation and a checkpoint every 4; then once more with
    ``--auto_resume`` up to iteration 10."""
    root = tmp_path_factory.mktemp('train')
    rng = np.random.RandomState(0)
    for gt_dir, lq_dir, count in (('GT', 'LQ', 6), ('val_GT', 'val_LQ', 2)):
        (root / gt_dir).mkdir()
        (root / lq_dir).mkdir()
        for i in range(count):
            gt = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / gt_dir / f'{i}.png'), gt)
            cv2.imwrite(str(root / lq_dir / f'{i}.png'),
                        cv2.resize(gt, (16, 16), interpolation=cv2.INTER_AREA))
    force = ['num_gpu=0', f'path:experiments_root={root / "experiments"}',
             f'datasets:train:dataroot_gt={root / "GT"}', f'datasets:train:dataroot_lq={root / "LQ"}',
             'datasets:train:gt_size=32', 'datasets:train:batch_size_per_gpu=2',
             f'datasets:val:dataroot_gt={root / "val_GT"}',
             f'datasets:val:dataroot_lq={root / "val_LQ"}',
             'network_g:depths=[2,2]', 'network_g:num_heads=[2,2]', 'network_g:embed_dim=24',
             'network_g:img_size=8', 'train:ema_decay=0.9', 'train:optim_g:lr=0.002']

    def run(*extra, overrides=()):
        steps = []
        step = SwinIRModel.optimize_parameters

        def recorded(model, current_iter):
            step(model, current_iter)
            steps.append((current_iter, model.get_current_learning_rate()[0],
                          model.get_current_log()['l_pix']))

        argv = sys.argv
        sys.argv = ['train.py', '-opt', CONFIG, *extra, '--force_yml', *force, *overrides]
        try:
            with mock.patch.object(SwinIRModel, 'optimize_parameters', recorded):
                model = port_train.train_pipeline(str(root))
        finally:
            sys.argv = argv
        return model, steps

    first = run()
    resumed = run('--auto_resume', overrides=['train:total_iter=10'])
    return root / 'experiments' / 'train_SwinIR_M_x4_synthetic', first, resumed


def test_train_pipeline_steps_checkpoints_and_states(trained):
    exp, (model, steps), _ = trained
    assert [s[0] for s in steps] == list(range(1, 9))
    assert all(np.isfinite(s[2]) for s in steps)
    # MultiStepLR of the config: halved from the 7th iteration on
    assert [s[1] for s in steps] == [0.002] * 6 + [0.001] * 2
    assert sorted(p.name for p in (exp / 'models').iterdir()) == [
        'net_g_4.pth', 'net_g_8.pth', 'net_g_latest.pth']
    assert (exp / 'train_SwinIR_M_x4_synthetic.yml').exists()
    assert list(exp.glob('train_*.log'))
    # validated at 4, at 8 and once more after the loop, which both packages
    # label total_iter + 1
    assert model.best_metric_results['SwinIR_M_x4_synthetic_val']['psnr']['iter'] in (4, 8, 9)
    ckpt = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)
    assert sorted(ckpt) == ['params', 'params_ema']
    assert ckpt['params'].keys() == ckpt['params_ema'].keys() == model.net_g.state_dict().keys()
    key = 'layers.1.residual_group.blocks.1.mlp.fc2.weight'
    assert not torch.equal(ckpt['params'][key], ckpt['params_ema'][key])
    state = torch.load(exp / 'training_states' / '8.state', weights_only=True)
    assert (state['iter'], state['epoch']) == (8, 2)   # 3 iterations an epoch
    assert len(state['optimizers']) == len(state['schedulers']) == 1
    assert 'drop_path_generator' in state


def test_auto_resume_continues_at_the_saved_iteration(trained):
    exp, (_, steps), (model, resumed_steps) = trained
    assert [s[0] for s in resumed_steps] == [9, 10]
    assert [s[1] for s in resumed_steps] == [0.001, 0.001]   # the scheduler resumed too
    assert port_misc.find_latest_checkpoint_iter(str(exp / 'training_states')) == 8
    assert port_misc.find_latest_checkpoint_iter(str(exp / 'no_such_dir')) is None
    assert osp.basename(model.opt['path']['pretrain_network_g']) == 'net_g_8.pth'
    # Adam's moments came back with the state: 10 steps taken in all
    state = model.optimizers[0].state_dict()['state']
    assert {int(s['step']) for s in state.values()} == {10}


def test_saved_pth_loads_in_the_jax_package_with_the_same_output(trained):
    """The reverse direction of the weights: ``net_g_8.pth`` as the port
    saved it, read by the JAX package's SwinIRModel (``params_ema``), gives
    the port's validation output on the same image; atol 1e-4, float32 sums
    in another order through 4 blocks."""
    exp, (model, _), _ = trained
    opt = yaml_load(CONFIG)
    opt.update(num_gpu=1, is_train=False, dist=False, rank=0, world_size=1)
    opt['network_g'].update(depths=[2, 2], num_heads=[2, 2], embed_dim=24, img_size=8)
    opt['path'] = {'pretrain_network_g': str(exp / 'models' / 'net_g_8.pth'),
                   'param_key_g': 'params_ema', 'strict_load_g': True}
    opt.pop('train')
    jax_model = jax_build_model(opt)
    lq = np.random.RandomState(3).rand(1, 3, 13, 16).astype(np.float32)
    jax_model.feed_data({'lq': lq.transpose(0, 2, 3, 1)})
    jax_model.test()

    fresh = SwinIR(**{k: v for k, v in opt['network_g'].items() if k != 'type'})
    model.load_network(fresh, opt['path']['pretrain_network_g'], True, 'params_ema')
    model.net_g_ema.load_state_dict(fresh.state_dict())
    model.feed_data({'lq': torch.from_numpy(lq)})
    model.test()
    assert model.output.shape == (1, 3, 52, 64)
    np.testing.assert_allclose(model.output.numpy(),
                               np.asarray(jax_model.output).transpose(0, 3, 1, 2), atol=1e-4)


def test_num_gpu_auto_without_a_card_raises_instead_of_training_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this check is about a host without CUDA')
    argv = sys.argv
    sys.argv = ['train.py', '-opt', CONFIG, '--force_yml',
                f'path:experiments_root={tmp_path / "experiments"}']
    try:
        with pytest.raises(RuntimeError, match='num_gpu'):
            port_train.train_pipeline(str(tmp_path))
    finally:
        sys.argv = argv
    assert not (tmp_path / 'experiments').exists()
