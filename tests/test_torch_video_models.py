"""The port's video models (``EDVRModel``, ``VideoRecurrentModel``) against
the JAX package's: Adam trajectories across the end of their warm-up freezes
with a learning-rate multiplier, the train and test pipelines on the CPU at a
small size, and a port checkpoint read back by the JAX package. Float32,
``num_gpu: 0``."""

import sys
from concurrent.futures import ThreadPoolExecutor
from os import path as osp
from unittest import mock

import cv2
import jax
import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.archs.basicvsrpp_arch import BasicVSRPlusPlus
from basicsr4rs_torch.archs.edvr_arch import EDVR
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.video_base_model import EDVRModel
from basicsr4rs_torch.models.video_recurrent_model import VideoRecurrentModel
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.models import build_model as _jax_build_model
from basicsr4rs_tpu.models.sr_model import SRModel as JaxSRModel

OPTIONS = osp.join(osp.dirname(__file__), '..', 'options')
EDVR_TRAIN = osp.join(OPTIONS, 'train', 'EDVR', 'train_EDVR_M_x4_synthetic.yml')
EDVR_TEST = osp.join(OPTIONS, 'test', 'EDVR', 'test_EDVR_M_x4_synthetic.yml')
PP_TRAIN = osp.join(OPTIONS, 'train', 'BasicVSRPP', 'train_BasicVSRPP_x4_synthetic.yml')
PP_TEST = osp.join(OPTIONS, 'test', 'BasicVSRPP', 'test_BasicVSRPP_x4_synthetic.yml')

EDVR_NET = dict(type='EDVR', num_feat=16, num_frame=3, deformable_groups=2, num_extract_block=1,
                num_reconstruct_block=1)
PP_NET = dict(type='BasicVSRPlusPlus', mid_channels=8, num_blocks=1)
LR, STEPS, BOUNDARY, EMA_DECAY = 1e-3, 5, 3, 0.9


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_build_model(opt):
    """The JAX package's model with its network's variables made as zeros of
    the right shapes (``jax.eval_shape``) instead of by an un-jitted
    ``init``, which takes a minute for the scanned BasicVSR++: every test
    here loads a ``.pth`` over them with ``strict_load_g``."""
    def shapes_only(model, init_rng):
        shapes = jax.eval_shape(model.net_g.init, init_rng, model._dummy_input())
        return jax.tree_util.tree_map(lambda s: jax.numpy.zeros(s.shape, s.dtype), shapes)

    assert opt['path']['pretrain_network_g'] and opt['path']['strict_load_g']
    with mock.patch.object(JaxSRModel, '_init_variables', shapes_only):
        return _jax_build_model(opt)


def nonzero_init(net, seed, path):
    """Save ``net`` with its zero-initialised offset convolutions made
    random, so that the deformable sampler shows in every step."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if 'conv_offset' in name and name.endswith('weight') and not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    torch.save({'params': net.state_dict()}, path)


def model_opt(model_type, network_g, init_path, train_extra):
    train = {'ema_decay': EMA_DECAY,
             'optim_g': {'type': 'Adam', 'lr': LR, 'weight_decay': 0, 'betas': [0.9, 0.99]},
             'scheduler': {'type': 'CosineAnnealingRestartLR', 'periods': [10],
                           'restart_weights': [1], 'eta_min': 1e-7},
             'total_iter': 10,
             'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0, 'reduction': 'mean'}}
    train.update(train_extra)
    return {'name': 'trajectory', 'model_type': model_type, 'scale': 4, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(network_g),
            'path': {'pretrain_network_g': init_path, 'strict_load_g': True},
            'train': train, 'val': {'val_freq': 100}}


def jax_trajectory(opt, arch, batches):
    """The JAX package's model through ``batches`` on one of the host's CPU
    devices (on all eight, the batch of one is replicated and every step
    runs eight times): per step its rate before the step and its loss, its
    parameters after iteration ``BOUNDARY`` and its EMA at the end, as
    state dicts of ``arch``."""
    from basicsr4rs_tpu.parallel import mesh as jax_mesh

    def state_dict(tree):
        return jax_params_to_state_dict(
            jax.tree_util.tree_map(np.array, jax.device_get(tree)), arch.JAX_KEY_RULES)

    one_device = mock.patch('basicsr4rs_tpu.models.base_model.create_mesh',
                            lambda opt: jax_mesh.create_mesh(opt, jax.devices()[:1]))
    with one_device:
        model = jax_build_model(opt)
    out = {'rates': [], 'losses': []}
    for current_iter, (lq, gt) in enumerate(batches, start=1):
        out['rates'].append(model.get_current_learning_rate()[0])
        model.feed_data({'lq': np.moveaxis(lq, -3, -1), 'gt': np.moveaxis(gt, -3, -1)})
        model.optimize_parameters(current_iter)
        out['losses'].append(model.get_current_log()['l_pix'])
        if current_iter == BOUNDARY:
            out['boundary'] = state_dict(model.state.params)
    out['ema'] = state_dict(model.state.ema_params)
    return out


def run_trajectories(opt, arch, batches, slow, frozen, multiplier):
    """Both packages' models through ``batches``, the JAX package's in a
    thread beside the port's (its trace and compile take most of the time).
    Checks the rates (the ``slow`` parameters' group keeps its ratio through
    the schedule), the losses, and what the warm-up freeze means: before
    iteration ``BOUNDARY`` the ``frozen`` parameters keep their values while
    Adam's moments and step count run; from it on they move, by what the JAX
    package's masked update moves them."""
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_trajectory, opt, arch, batches)
        port_model = port_build_model(opt)
        init = {k: v.detach().clone() for k, v in port_model.net_g.named_parameters()}
        assert any(slow(k) for k in init) and any(frozen(k) for k in init)
        assert not all(frozen(k) for k in init)
        groups = port_model.optimizer_g.param_groups
        assert len(groups) == 2
        rates, losses, at_boundary = [], [], None
        for current_iter, (lq, gt) in enumerate(batches, start=1):
            port_model.update_learning_rate(current_iter)
            rates.append(port_model.get_current_learning_rate())
            port_model.feed_data({'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt)})
            port_model.optimize_parameters(current_iter)
            losses.append(port_model.get_current_log()['l_pix'])
            params = dict(port_model.net_g.named_parameters())
            if current_iter == BOUNDARY - 1:
                for key, p in params.items():
                    assert torch.equal(p, init[key]) == frozen(key), key
                    state = port_model.optimizer_g.state[p]
                    assert int(state['step']) == current_iter and state['exp_avg'].abs().max() > 0
            if current_iter == BOUNDARY:
                at_boundary = {k: p.detach().clone() for k, p in params.items()}
        want = jax_run.result()
    for got, jax_rate in zip(rates, want['rates']):
        assert got[1] == pytest.approx(got[0] * multiplier, rel=1e-9)
        assert got[0] == pytest.approx(jax_rate, rel=1e-6)
    # the JAX package's own bound for a trajectory against a torch reference
    np.testing.assert_allclose(losses, want['losses'], rtol=5e-4, atol=5e-5)
    assert abs(losses[0] - losses[-1]) > 1e-5
    # the first kept update of a frozen parameter: with moments that ran from
    # iteration 1 it is the JAX package's to a few percent of the rate (Adam
    # divides by the gradient's size, so single entries whose gradient is
    # rounding noise may differ by the rate itself: the median is held); with
    # moments started at the boundary every entry would move by the full rate
    assert want['boundary'].keys() == at_boundary.keys()
    for key, p in at_boundary.items():
        if frozen(key):
            got_step = (p - init[key]).numpy()
            want_step = (want['boundary'][key] - init[key]).numpy()
            rate = LR * (multiplier if slow(key) else 1.)
            assert 0 < np.abs(got_step).max() <= 1.01 * rate, key
            assert np.median(np.abs(got_step - want_step)) <= 0.05 * rate, key
    for key, value in port_model.net_g_ema.named_parameters():
        np.testing.assert_allclose(value.detach().numpy(), want['ema'][key].numpy(), atol=10 * LR,
                                   rtol=0, err_msg=f'EMA of {key}')
    return port_model


def test_edvr_model_adam_trajectory_across_tsa_iter(tmp_path):
    """``tsa_iter: 3`` and ``dcn_lr_mul: 0.5``: in iterations 1 and 2 only the
    fusion module moves."""
    net_opt = {k: v for k, v in EDVR_NET.items() if k != 'type'}
    torch.manual_seed(1)
    init_path = str(tmp_path / 'init.pth')
    nonzero_init(EDVR(**net_opt), 2, init_path)
    opt = model_opt('EDVRModel', EDVR_NET, init_path, {'tsa_iter': BOUNDARY, 'dcn_lr_mul': 0.5})
    rng = np.random.RandomState(7)
    batches = [(rng.rand(2, 3, 3, 16, 16).astype(np.float32),
                rng.rand(2, 3, 64, 64).astype(np.float32)) for _ in range(STEPS)]
    model = run_trajectories(opt, EDVR, batches, slow=lambda k: 'dcn' in k,
                             frozen=lambda k: 'fusion' not in k.split('.'), multiplier=0.5)
    assert isinstance(model, EDVRModel)


def test_video_recurrent_model_adam_trajectory_across_fix_flow(tmp_path):
    """``fix_flow: 3`` and ``flow_lr_mul: 0.25``: SpyNet stays put in
    iterations 1 and 2, then learns at a quarter of the rate."""
    net_opt = {k: v for k, v in PP_NET.items() if k != 'type'}
    torch.manual_seed(3)
    init_path = str(tmp_path / 'init.pth')
    nonzero_init(BasicVSRPlusPlus(**net_opt), 4, init_path)
    opt = model_opt('VideoRecurrentModel', PP_NET, init_path,
                    {'fix_flow': BOUNDARY, 'flow_lr_mul': 0.25})
    rng = np.random.RandomState(8)
    batches = [(rng.rand(1, 2, 3, 64, 64).astype(np.float32),
                rng.rand(1, 2, 3, 256, 256).astype(np.float32)) for _ in range(STEPS - 1)]
    model = run_trajectories(opt, BasicVSRPlusPlus, batches, slow=lambda k: 'spynet' in k,
                             frozen=lambda k: 'spynet' in k, multiplier=0.25)
    assert isinstance(model, VideoRecurrentModel)


def test_a_unit_multiplier_keeps_one_param_group(tmp_path):
    init_path = str(tmp_path / 'init.pth')
    torch.save({'params': EDVR(**{k: v for k, v in EDVR_NET.items() if k != 'type'}).state_dict()},
               init_path)
    model = port_build_model(model_opt('EDVRModel', EDVR_NET, init_path, {'dcn_lr_mul': 1}))
    assert len(model.optimizer_g.param_groups) == 1
    assert model.frozen_parameters(1) == []


def test_log_dcn_offset_reaches_every_pack(tmp_path):
    from basicsr4rs_torch.ops.dcn import DCNv2Pack
    init_path = str(tmp_path / 'init.pth')
    torch.save({'params': EDVR(**{k: v for k, v in EDVR_NET.items() if k != 'type'}).state_dict()},
               init_path)
    for asked in (False, True):
        model = port_build_model(model_opt('EDVRModel', EDVR_NET, init_path,
                                           {'log_dcn_offset': asked}))
        packs = [m for m in model.net_g.modules() if isinstance(m, DCNv2Pack)]
        assert len(packs) == 4 and all(m.log_offset == asked for m in packs)


# ------------------------------------------------------------ the pipelines
def write_clips(root, sets, rng):
    """``sets``: {name: (clips {clip: frames}, (LQ height, LQ width))}; GT and
    LQ frames under ``<name>_GT`` / ``<name>_LQ`` and ``meta_info_<name>.txt``."""
    for name, (clips, (h, w)) in sets.items():
        for clip, frames in clips.items():
            for sub, size in (('GT', (4 * h, 4 * w)), ('LQ', (h, w))):
                (root / f'{name}_{sub}' / clip).mkdir(parents=True)
                for i in range(frames):
                    cv2.imwrite(str(root / f'{name}_{sub}' / clip / f'{i:08d}.png'),
                                (rng.rand(*size, 3) * 255).astype(np.uint8))
        (root / f'meta_info_{name}.txt').write_text(''.join(
            f'{clip} {frames} ({4 * h},{4 * w},3)\n' for clip, frames in clips.items()))


def data_overrides(root, phases):
    out = []
    for phase, name in phases.items():
        out += [f'datasets:{phase}:dataroot_gt={root / (name + "_GT")}',
                f'datasets:{phase}:dataroot_lq={root / (name + "_LQ")}',
                f'datasets:{phase}:meta_info_file={root / ("meta_info_" + name + ".txt")}']
    return out


def run_pipeline(entry, config, root, force, model_cls, extra=()):
    steps = []
    step = model_cls.optimize_parameters

    def recorded(model, current_iter):
        step(model, current_iter)
        steps.append((current_iter, tuple(model.get_current_learning_rate()),
                      model.get_current_log()['l_pix']))

    argv = sys.argv
    sys.argv = ['entry.py', '-opt', config, *extra, '--force_yml', *force]
    try:
        with mock.patch.object(model_cls, 'optimize_parameters', recorded):
            pipeline = getattr(entry, 'train_pipeline', None) or entry.test_pipeline
            model = pipeline(str(root))
    finally:
        sys.argv = argv
    return model, steps


EDVR_SHRINK = ['num_gpu=0', 'network_g:num_feat=16', 'network_g:deformable_groups=2',
               'network_g:num_extract_block=1', 'network_g:num_reconstruct_block=1',
               'network_g:num_frame=3']


@pytest.fixture(scope='module')
def edvr_trained(tmp_path_factory):
    """``train_pipeline`` on the EDVR config cut to width 16, 3 frames, LQ
    clips of 16x16 (GT 32 crops), 8 iterations, ``dcn_lr_mul: 0.5``; then
    ``--auto_resume`` up to iteration 10."""
    root = tmp_path_factory.mktemp('edvr')
    write_clips(root, {'train': ({'100': 5, '101': 4}, (16, 16)), 'val': ({'200': 3}, (16, 16)),
                       'test': ({'300': 3, '301': 4}, (12, 16))}, np.random.RandomState(0))
    force = (EDVR_SHRINK + [f'path:experiments_root={root / "experiments"}',
                            'datasets:train:num_frame=3', 'datasets:val:num_frame=3',
                            'datasets:train:gt_size=32', 'datasets:train:batch_size_per_gpu=2',
                            'train:ema_decay=0.9', 'train:dcn_lr_mul=0.5']
             + data_overrides(root, {'train': 'train', 'val': 'val'}))
    first = run_pipeline(port_train, EDVR_TRAIN, root, force, EDVRModel)
    resumed = run_pipeline(port_train, EDVR_TRAIN, root, force + ['train:total_iter=10'],
                           EDVRModel, extra=['--auto_resume'])
    return root, first, resumed


def test_edvr_train_pipeline(edvr_trained):
    root, (model, steps), (resumed_model, resumed_steps) = edvr_trained
    exp = root / 'experiments' / 'train_EDVR_M_x4_synthetic'
    assert [s[0] for s in steps] == list(range(1, 9))
    assert all(np.isfinite(s[2]) for s in steps)
    for _, rates, _ in steps:   # the dcn group keeps half the rate down the cosine
        assert len(rates) == 2 and rates[1] == pytest.approx(0.5 * rates[0])
    assert steps[0][1][0] == pytest.approx(4e-4) and steps[-1][1][0] < 1e-4
    assert sorted(p.name for p in (exp / 'models').iterdir()) == [
        'net_g_4.pth', 'net_g_8.pth', 'net_g_latest.pth']
    record = model.best_metric_results['EDVR_M_x4_synthetic_val']['psnr']
    assert record['iter'] in (4, 8, 9) and np.isfinite(record['val'])
    assert model.metric_results_per_folder['200'].shape == (3, 1)
    ckpt = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)
    assert sorted(ckpt) == ['params', 'params_ema']
    assert ckpt['params'].keys() == model.net_g.state_dict().keys()
    assert [s[0] for s in resumed_steps] == [9, 10]
    state = resumed_model.optimizers[0].state_dict()['state']
    assert {int(s['step']) for s in state.values()} == {10}


def test_edvr_warm_up_in_the_pipeline(edvr_trained):
    """``tsa_iter: 4`` of the config: ``net_g_4.pth`` is saved after the first
    step that trains everything, so its alignment has moved; the ``.pth`` of
    a run cut at 3 iterations has only the fusion module changed."""
    root, (model, _), _ = edvr_trained
    exp = root / 'experiments' / 'train_EDVR_M_x4_synthetic'
    at_4 = torch.load(exp / 'models' / 'net_g_4.pth', weights_only=True)['params']
    at_8 = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)['params']
    key = 'pcd_align.dcn_pack.l1.conv_offset.weight'
    assert at_4[key].abs().max() > 0 and not torch.equal(at_4[key], at_8[key])
    assert not torch.equal(at_4['fusion.feat_fusion.weight'], at_8['fusion.feat_fusion.weight'])


def test_edvr_test_pipeline_and_the_jax_package_read_the_checkpoint(edvr_trained):
    """``basicsr4rs_torch.test`` on the trained ``params_ema``: per-clip PSNR
    rows and saved images; then the same ``.pth`` in the JAX package's
    ``EDVRModel`` gives the same centre frame (atol 1e-4 on the [0, 1]
    output, float32 sums in another order)."""
    root, _, _ = edvr_trained
    ckpt = str(root / 'experiments' / 'train_EDVR_M_x4_synthetic' / 'models' / 'net_g_8.pth')
    force = (EDVR_SHRINK + [f'path:results_root={root / "results"}',
                            f'path:pretrain_network_g={ckpt}', 'path:param_key_g=params_ema',
                            'datasets:test_1:num_frame=3']
             + data_overrides(root, {'test_1': 'test'}))
    model, _ = run_pipeline(port_test, EDVR_TEST, root, force, EDVRModel)
    rows = model.metric_results_per_folder
    assert sorted(rows) == ['300', '301'] and rows['301'].shape == (4, 1)
    assert np.isfinite(model.metric_results['psnr'])
    assert model.metric_results['psnr'] == pytest.approx(
        np.mean([rows['300'].mean(), rows['301'].mean()]), rel=1e-6)
    images = sorted(p.name for p in (root / 'results').rglob('*.png'))
    assert len(images) == 7 and images[0] == '00000000_EDVR_M_x4_synthetic.png'

    opt = yaml_load(EDVR_TEST)
    opt.update(num_gpu=1, is_train=False, dist=False, rank=0, world_size=1)
    opt['network_g'].update(num_feat=16, deformable_groups=2, num_extract_block=1,
                            num_reconstruct_block=1, num_frame=3)
    opt['path'] = {'pretrain_network_g': ckpt, 'param_key_g': 'params_ema', 'strict_load_g': True}
    jax_model = jax_build_model(opt)
    lq = np.random.RandomState(3).rand(1, 3, 3, 12, 16).astype(np.float32)
    jax_model.feed_data({'lq': np.moveaxis(lq, -3, -1)})
    jax_model.test()
    model.feed_data({'lq': torch.from_numpy(lq)})
    model.test()
    assert model.output.shape == (1, 3, 48, 64)
    np.testing.assert_allclose(model.output.numpy(),
                               np.moveaxis(np.asarray(jax_model.output), -1, -3), atol=1e-4)


PP_SHRINK = ['num_gpu=0', 'network_g:mid_channels=8', 'network_g:num_blocks=1']


@pytest.fixture(scope='module')
def pp_trained(tmp_path_factory):
    """``train_pipeline`` on the BasicVSR++ config cut to width 8, one block a
    branch, clips of 2 frames at LQ 64x64 (its smallest), 8 iterations."""
    root = tmp_path_factory.mktemp('pp')
    write_clips(root, {'train': ({'100': 4, '101': 3}, (64, 64)), 'val': ({'200': 2}, (64, 64)),
                       'test': ({'300': 3}, (64, 72))}, np.random.RandomState(1))
    force = (PP_SHRINK + [f'path:experiments_root={root / "experiments"}',
                          'datasets:train:num_frame=2', 'datasets:train:num_worker_per_gpu=1',
                          'train:ema_decay=0.9']
             + data_overrides(root, {'train': 'train'})
             + [f'datasets:val:dataroot_gt={root / "val_GT"}',
                f'datasets:val:dataroot_lq={root / "val_LQ"}'])
    return root, run_pipeline(port_train, PP_TRAIN, root, force, VideoRecurrentModel)


def test_basicvsrpp_train_pipeline(pp_trained):
    root, (model, steps) = pp_trained
    exp = root / 'experiments' / 'train_BasicVSRPP_x4_synthetic'
    assert [s[0] for s in steps] == list(range(1, 9))
    assert all(np.isfinite(s[2]) for s in steps)
    for _, rates, _ in steps:   # SpyNet's group keeps a quarter of the rate
        assert len(rates) == 2 and rates[1] == pytest.approx(0.25 * rates[0])
    assert sorted(p.name for p in (exp / 'models').iterdir()) == [
        'net_g_4.pth', 'net_g_8.pth', 'net_g_latest.pth']
    assert model.metric_results_per_folder['200'].shape == (2, 1)
    assert np.isfinite(model.metric_results['psnr'])
    # fix_flow: 4 of the config: SpyNet has moved by iteration 8, and its
    # normalisation constants are not in the file
    init = torch.load(exp / 'models' / 'net_g_4.pth', weights_only=True)['params']
    last = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)['params']
    key = 'spynet.basic_module.5.basic_module.8.weight'
    assert not torch.equal(init[key], last[key])
    assert not any(k.endswith(('mean', 'std')) for k in last)


def test_basicvsrpp_test_pipeline_and_the_jax_package_read_the_checkpoint(pp_trained):
    """``basicsr4rs_torch.test`` on the trained ``params_ema``; then the same
    ``.pth`` in the JAX package's ``VideoRecurrentModel`` gives the same
    frames (atol 1e-4 on the [0, 1] output), also averaged with the reversed
    clip (``flip_seq``) and cut to the centre frame (``center_frame_only``)."""
    root, _ = pp_trained
    ckpt = str(root / 'experiments' / 'train_BasicVSRPP_x4_synthetic' / 'models' / 'net_g_8.pth')
    force = PP_SHRINK + [f'path:results_root={root / "results"}',
                         f'path:pretrain_network_g={ckpt}', 'path:param_key_g=params_ema',
                         f'datasets:test_1:dataroot_gt={root / "test_GT"}',
                         f'datasets:test_1:dataroot_lq={root / "test_LQ"}']
    model, _ = run_pipeline(port_test, PP_TEST, root, force, VideoRecurrentModel)
    rows = model.metric_results_per_folder['300']
    assert rows.shape == (3, 1) and np.all(np.isfinite(rows)) and np.all(rows > 0)
    images = sorted(p.name for p in (root / 'results').rglob('*.png'))
    assert images == [f'{i:08d}_BasicVSRPP_x4_synthetic.png' for i in range(3)]

    opt = yaml_load(PP_TEST)
    opt.update(num_gpu=1, is_train=False, dist=False, rank=0, world_size=1)
    opt['network_g'].update(mid_channels=8, num_blocks=1)
    opt['path'] = {'pretrain_network_g': ckpt, 'param_key_g': 'params_ema', 'strict_load_g': True}
    jax_model = jax_build_model(opt)
    lq = np.random.RandomState(5).rand(1, 2, 3, 64, 64).astype(np.float32)
    for flip_seq, center_frame_only in ((False, False), (False, True), (True, False)):
        for m in (model, jax_model):
            m.opt['val'].update(flip_seq=flip_seq, center_frame_only=center_frame_only)
        jax_model.feed_data({'lq': np.moveaxis(lq, -3, -1)})
        jax_model.test()
        model.feed_data({'lq': torch.from_numpy(lq)})
        model.test()
        shape = (1, 3, 256, 256) if center_frame_only else (1, 2, 3, 256, 256)
        assert model.output.shape == shape
        np.testing.assert_allclose(model.output.numpy(),
                                   np.moveaxis(np.asarray(jax_model.output), -1, -3), atol=1e-4,
                                   err_msg=f'{flip_seq} {center_frame_only}')


def test_center_frame_only_fills_one_metric_row(pp_trained):
    root, _ = pp_trained
    ckpt = str(root / 'experiments' / 'train_BasicVSRPP_x4_synthetic' / 'models' / 'net_g_8.pth')
    force = PP_SHRINK + [f'path:results_root={root / "results_center"}',
                         f'path:pretrain_network_g={ckpt}', 'val:center_frame_only=true',
                         f'datasets:test_1:dataroot_gt={root / "test_GT"}',
                         f'datasets:test_1:dataroot_lq={root / "test_LQ"}']
    model, _ = run_pipeline(port_test, PP_TEST, root, force, VideoRecurrentModel)
    rows = model.metric_results_per_folder['300']
    assert rows[0, 0] > 0 and np.all(rows[1:] == 0)
    assert len(list((root / 'results_center').rglob('*.png'))) == 1
