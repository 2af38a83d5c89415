"""The port's ``ResShiftModel`` (basicsr4rs_torch/models/resshift_model.py,
srrs_model.py) against the JAX package's, and the slice as a whole: loss
trajectories under SGD and Adam from one ``.pth`` with the timesteps and the
noise handed to both, the EMA, the skipped step on a non-finite loss,
sampling, bfloat16 autocast, and ``train.py`` / ``test.py`` end to end on a
tiny config with a checkpoint that the JAX package reads back. Everything on
the CPU (``num_gpu: 0``), float32 unless said."""

import copy
import csv
import sys
from os import path as osp
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
from basicsr4rs_torch.archs.unet_arch import UNetModelSwin
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.resshift_model import ResShiftModel
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.archs import autoencoder_arch as jax_ae
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import resshift_model as jax_resshift_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_unet import assert_close_rel, nchw, nhwc

ROOT = osp.join(osp.dirname(__file__), '..')
TRAIN_CONFIG = osp.join(ROOT, 'options', 'train', 'ResShift', 'train_ResShift_x4_synthetic.yml')
TEST_CONFIG = osp.join(ROOT, 'options', 'test', 'ResShift', 'test_ResShift_x4_synthetic.yml')

NET = dict(type='UNetModelSwin', image_size=16, in_channels=3, model_channels=8, out_channels=3,
           num_res_blocks=[1, 1], attention_resolutions=[16, 8], channel_mult=[1, 2],
           num_head_channels=4, swin_embed_dim=8, window_size=4, mlp_ratio=4,
           use_scale_shift_norm=True, cond_lq=True, lq_size=16)
AE = dict(type='VQModelTorch', n_embed=16, embed_dim=3,
          ddconfig=dict(ch=8, out_ch=3, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                        in_channels=3, resolution=32, z_channels=3, double_z=False))
DIFFUSION = dict(normalize_input=True, schedule_name='exponential', sf=4, min_noise_level=0.2,
                 steps=4, kappa=2.0, etas_end=0.99, schedule_kwargs={'power': 0.3},
                 predict_type='xstart', timestep_respacing=None, scale_factor=1.0,
                 latent_flag=True, weighted_mse=False)
OPTIMIZERS = {'SGD': dict(type='SGD', lr=1e-2),
              'Adam': dict(type='Adam', lr=1e-3, weight_decay=0, betas=[0.9, 0.99])}
EMA_DECAY = 0.9


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shapes_only(init):
    """``jit_init`` that only traces: the variables come out as zeros of
    their shapes, for a model whose every variable a test then loads (an
    un-jitted init of the UNet takes most of a minute on the CPU)."""
    def zeros(*args):
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      jax.eval_shape(init, *args))
    return zeros


def _opt(optim='SGD', init_path=None, **train):
    return {'name': 'resshift', 'model_type': 'ResShiftModel', 'scale': 4, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': copy.deepcopy(NET), 'autoencoder': copy.deepcopy(AE),
            'diffusion': copy.deepcopy(DIFFUSION),
            'path': {'pretrain_network_g': init_path, 'pretrain_network_ae': None,
                     'strict_load_g': True},
            'train': {'ema_decay': EMA_DECAY, 'use_amp': False,
                      'optim_g': dict(OPTIMIZERS[optim]), 'scheduler': {'type': 'ConstantLR'},
                      'total_iter': 100, **train},
            'val': {'val_freq': 100}}


def _nonzero_(net, seed):
    """Every parameter random and non-zero, so that the zero-initialised
    convolutions hide nothing upstream."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1 and not name.endswith('relative_position_bias_table'):
                p.normal_(0, p[0].numel()**-0.5, generator=gen)
            elif name.endswith('weight'):       # norm scales
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.normal_(0, 0.05, generator=gen)
    return net


@pytest.fixture(scope='module')
def init(tmp_path_factory):
    """One init for both packages: the port's UNet saved as a ``.pth``, and
    the port's first stage's state_dict."""
    net = _nonzero_(UNetModelSwin(**{k: v for k, v in NET.items() if k != 'type'}), 1)
    path = str(tmp_path_factory.mktemp('init') / 'net_g.pth')
    torch.save({'params': net.state_dict()}, path)
    stage = _nonzero_(VQModelTorch(**{k: v for k, v in AE.items() if k != 'type'}), 2)
    return path, stage.state_dict()


def _pair(optim, init, **train):
    """The two packages' models from the same weights. The JAX package reads
    the UNet's ``.pth`` through its own converter; the first stage's weights
    go in through ``convert_torch_state_dict`` with the JAX module's rules."""
    path, stage = init
    port_model = port_build_model(_opt(optim, path, **train))
    port_model.first_stage.load_state_dict(stage)
    with mock.patch.object(jax_sr_model, 'jit_init', _shapes_only), \
            mock.patch.object(jax_resshift_model, 'jit_init', _shapes_only):
        jax_model = jax_build_model(_opt(optim, path, **train))
    jax_model.first_stage.params = jax.tree_util.tree_map(jnp.asarray, convert_torch_state_dict(
        stage, rules=jax_ae.VQModelTorch.TORCH_KEY_RULES))
    return port_model, jax_model


def _batch(rng, b=2):
    return {'lq': (rng.rand(b, 3, 8, 8) * 2 - 1).astype(np.float32),
            'gt': (rng.rand(b, 3, 32, 32) * 2 - 1).astype(np.float32),
            'tt': rng.randint(0, 4, size=(b,)).astype(np.int32),
            'noise': rng.randn(b, 3, 16, 16).astype(np.float32)}


def _feed(port_model, jax_model, batch):
    port_model.feed_data({k: torch.from_numpy(v).long() if k == 'tt' else torch.from_numpy(v)
                          for k, v in batch.items()})
    jax_model.feed_data({k: v if v.ndim == 1 else np.transpose(v, (0, 2, 3, 1))
                         for k, v in batch.items()})


@pytest.fixture(scope='module')
def trajectories(init, request):
    """3 steps of both packages' models under the optimizer
    ``request.param``, from one init, on the same batches, timesteps and
    noise: the logged losses and the EMA trees. (Run here, once an
    optimizer: the JAX step's compilation is most of the time.)"""
    optim = request.param
    port_model, jax_model = _pair(optim, init)
    rng = np.random.RandomState(3)
    port_logs, jax_logs = [], []
    for current_iter in range(1, 4):
        _feed(port_model, jax_model, _batch(rng))
        port_model.update_learning_rate(current_iter)
        port_model.optimize_parameters(current_iter)
        jax_model.optimize_parameters(current_iter)
        port_logs.append(port_model.get_current_log())
        jax_logs.append(jax_model.get_current_log())
    tree = jax.tree_util.tree_map(np.array, jax.device_get(jax_model.state.ema_params))
    return (optim, port_logs, jax_logs, dict(port_model.net_g_ema.named_parameters()),
            jax_params_to_state_dict(tree, UNetModelSwin.JAX_KEY_RULES),
            port_model.skipped_steps)


@pytest.mark.parametrize('trajectories', list(OPTIMIZERS), indirect=True)
def test_loss_trajectory_matches_jax(trajectories):
    """Every logged loss of every step within 1e-4 relative (float32 sums in
    another order through the first stage and the UNet)."""
    _, port_logs, jax_logs, _, _, skipped = trajectories
    assert list(port_logs[0]) == list(jax_logs[0]) == ['loss', 'mse', 'mse1', 'mse3', 'mse4']
    for got, want in zip(port_logs, jax_logs):
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-7), key
    assert abs(port_logs[0]['loss'] - port_logs[-1]['loss']) > 1e-4   # it trained
    assert skipped == 0


@pytest.mark.parametrize('trajectories', list(OPTIMIZERS), indirect=True)
def test_ema_after_three_steps_matches_jax(trajectories):
    """After SGD within 1e-4 of each tensor's largest entry; after Adam
    (which divides by the gradient's size, so an entry whose gradient is
    rounding noise moves by the rate in either direction) within 2 x 3 steps
    x rate."""
    optim, _, _, got_ema, want_ema, _ = trajectories
    assert got_ema.keys() == want_ema.keys()
    lr = OPTIMIZERS[optim]['lr']
    for key, value in got_ema.items():
        if optim == 'SGD':
            assert_close_rel(value.detach().numpy(), want_ema[key].numpy(), 1e-4, key)
        else:
            np.testing.assert_allclose(value.detach().numpy(), want_ema[key].numpy(),
                                       atol=6 * lr, rtol=0, err_msg=key)


def test_a_non_finite_loss_skips_the_step_in_both_packages(init):
    port_model, jax_model = _pair('Adam', init)
    rng = np.random.RandomState(4)
    bad = _batch(rng)
    bad['gt'][0, 0, 0, 0] = np.nan
    before = copy.deepcopy(port_model.net_g.state_dict())
    jax_before = jax.tree_util.tree_map(np.array, jax.device_get(jax_model.state.params))
    _feed(port_model, jax_model, bad)
    port_model.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    assert not np.isfinite(port_model.get_current_log()['loss'])
    assert not np.isfinite(jax_model.get_current_log()['loss'])
    assert (port_model.skipped_steps, port_model.consecutive_skips) == (1, 1)
    for key, value in port_model.net_g.state_dict().items():
        assert torch.equal(value, before[key]), key
    jax_after = jax.tree_util.tree_map(np.array, jax.device_get(jax_model.state.params))
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_after, jax_before)
    assert not port_model.optimizer_g.state   # Adam has taken no step

    good = _batch(rng)
    _feed(port_model, jax_model, good)
    port_model.optimize_parameters(2)
    jax_model.optimize_parameters(2)
    assert port_model.consecutive_skips == 0 and port_model.skipped_steps == 1
    assert port_model.get_current_log()['loss'] == pytest.approx(
        jax_model.get_current_log()['loss'], rel=1e-4)
    assert not torch.equal(port_model.net_g.state_dict()['out.2.weight'], before['out.2.weight'])


def test_first_stage_is_frozen_and_draws_come_from_the_models_generator(init):
    port_model, _ = _pair('SGD', init)
    assert not port_model.first_stage.training
    assert not any(p.requires_grad for p in port_model.first_stage.parameters())
    batch = _batch(np.random.RandomState(5))
    losses = []
    for seed in (0, 0, 1):
        port_model.generator.manual_seed(seed)
        port_model.feed_data({'lq': torch.from_numpy(batch['lq']),
                              'gt': torch.from_numpy(batch['gt'])})
        loss, logs = port_model.compute_losses()
        losses.append(float(loss.detach()))
        assert list(logs) == ['loss', 'mse', 'mse1', 'mse3', 'mse4']
    assert losses[0] == losses[1] != losses[2]
    assert all(p.grad is None for p in port_model.first_stage.parameters())


def test_sampling_runs_the_whole_chain_on_the_ema_weights(init):
    port_model, jax_model = _pair('SGD', init)
    batch = _batch(np.random.RandomState(6))
    _feed(port_model, jax_model, batch)
    calls = []
    hook = port_model.net_g_ema.register_forward_hook(lambda *a: calls.append(1))
    port_model.generator.manual_seed(7)
    port_model.test()
    first = port_model.output.clone()
    port_model.generator.manual_seed(7)
    port_model.test()
    hook.remove()
    assert len(calls) == 2 * DIFFUSION['steps']
    assert first.shape == (2, 3, 32, 32) and torch.isfinite(first).all()
    assert torch.equal(first, port_model.output)
    assert port_model.net_g.training and not port_model.net_g_ema.training
    jax_model.test()
    assert np.asarray(jax_model.output).shape == (2, 32, 32, 3)
    # the two chains draw different noise; both land in the decoder's range
    assert abs(float(first.mean()) - float(np.asarray(jax_model.output).mean())) < 1.0


def test_bfloat16_autocast_step_is_finite_and_near_float32(init):
    """``use_amp: true``: the UNet runs under bfloat16 autocast, the first
    stage and the loss in float32, no scaler; the loss is within 5% of the
    float32 step's (bfloat16 keeps 8 bits)."""
    batch = _batch(np.random.RandomState(8))
    losses = {}
    for use_amp in (False, True):
        port_model, _ = _pair('SGD', init, use_amp=use_amp)
        assert port_model.use_amp is use_amp
        port_model.feed_data({k: torch.from_numpy(v).long() if k == 'tt'
                              else torch.from_numpy(v) for k, v in batch.items()})
        port_model.optimize_parameters(1)
        losses[use_amp] = port_model.get_current_log()['loss']
        assert all(p.grad.dtype == torch.float32 for p in port_model.net_g.parameters())
    assert np.isfinite(losses[True])
    assert losses[True] == pytest.approx(losses[False], rel=5e-2)
    assert losses[True] != losses[False]


# ------------------------------------------------------------- the pipelines
SHRINK = ['num_gpu=0',
          'network_g:image_size=16', 'network_g:lq_size=16', 'network_g:model_channels=8',
          'network_g:channel_mult=[1,2]', 'network_g:num_res_blocks=[1,1]',
          'network_g:attention_resolutions=[16,8]', 'network_g:swin_embed_dim=8',
          'network_g:num_head_channels=4', 'network_g:window_size=4',
          'autoencoder:n_embed=16', 'autoencoder:ddconfig:ch=8',
          'autoencoder:ddconfig:ch_mult=[1,2]', 'autoencoder:ddconfig:num_res_blocks=1',
          'autoencoder:ddconfig:resolution=32', 'diffusion:steps=4',
          'diffusion:min_noise_level=0.2']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """``train_pipeline`` on the synthetic config cut to a two-level UNet of
    width 8 behind an f2 first stage, 4 diffusion steps, 6 training pairs
    (GT 32x32) and 2 validation pairs: 8 iterations with validation and a
    checkpoint every 4, then ``--auto_resume`` up to iteration 10; and
    ``test_pipeline`` on the test config cut the same way, reading the
    trained checkpoint."""
    root = tmp_path_factory.mktemp('resshift')
    rng = np.random.RandomState(0)
    for gt_dir, lq_dir, count in (('GT', 'LQ', 6), ('val_GT', 'val_LQ', 2)):
        (root / gt_dir).mkdir()
        (root / lq_dir).mkdir()
        for i in range(count):
            gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / gt_dir / f'{i}.png'), gt)
            cv2.imwrite(str(root / lq_dir / f'{i}.png'),
                        cv2.resize(gt, (8, 8), interpolation=cv2.INTER_AREA))
    force = SHRINK + [f'path:experiments_root={root / "experiments"}',
                      f'datasets:train:dataroot_gt={root / "GT"}',
                      f'datasets:train:dataroot_lq={root / "LQ"}',
                      'datasets:train:gt_size=32', 'datasets:train:batch_size_per_gpu=2',
                      f'datasets:val:dataroot_gt={root / "val_GT"}',
                      f'datasets:val:dataroot_lq={root / "val_LQ"}',
                      'train:ema_decay=0.9', 'train:optim_g:lr=0.002', 'train:warmup_iter=-1']

    def run(*extra, overrides=()):
        steps = []
        step = ResShiftModel.optimize_parameters

        def recorded(model, current_iter):
            step(model, current_iter)
            steps.append((current_iter, model.get_current_log()['loss']))

        argv = sys.argv
        sys.argv = ['train.py', '-opt', TRAIN_CONFIG, *extra, '--force_yml', *force, *overrides]
        try:
            with mock.patch.object(ResShiftModel, 'optimize_parameters', recorded):
                model = port_train.train_pipeline(str(root))
        finally:
            sys.argv = argv
        return model, steps

    first = run()
    resumed = run('--auto_resume', overrides=['train:total_iter=10'])
    exp = root / 'experiments' / 'train_ResShift_x4_synthetic'

    # the first stage has no file of its own in a training run: save the one
    # the trained model holds, as the test config's pretrain_network_ae
    ae_path = root / 'autoencoder.pth'
    torch.save({'params': first[0].first_stage.state_dict()}, ae_path)
    argv = sys.argv
    sys.argv = ['test.py', '-opt', TEST_CONFIG, '--force_yml', *SHRINK,
                f'path:results_root={root / "results"}',
                f'datasets:test_1:dataroot_gt={root / "val_GT"}',
                f'datasets:test_1:dataroot_lq={root / "val_LQ"}',
                f'path:pretrain_network_g={exp / "models" / "net_g_8.pth"}',
                'path:param_key_g=params_ema', f'path:pretrain_network_ae={ae_path}']
    try:
        tested = port_test.test_pipeline(str(root))
    finally:
        sys.argv = argv
    return root, exp, first, resumed, tested


def test_train_pipeline_steps_checkpoints_and_states(trained):
    _, exp, (model, steps), _, _ = trained
    assert [s[0] for s in steps] == list(range(1, 9))
    assert all(np.isfinite(s[1]) for s in steps)
    assert sorted(p.name for p in (exp / 'models').iterdir()) == [
        'net_g_4.pth', 'net_g_8.pth', 'net_g_latest.pth']
    ckpt = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)
    assert sorted(ckpt) == ['params', 'params_ema']
    assert ckpt['params'].keys() == model.net_g.state_dict().keys()
    assert not torch.equal(ckpt['params']['out.2.weight'], ckpt['params_ema']['out.2.weight'])
    assert not any(k.startswith(('first_stage', 'encoder', 'decoder')) for k in ckpt['params'])
    state = torch.load(exp / 'training_states' / '8.state', weights_only=True)
    assert state['iter'] == 8 and 'noise_generator' in state
    assert model.device.type == 'cpu' and model.skipped_steps == 0


def test_validation_writes_a_csv_row_per_image_and_rgb_visuals(trained):
    _, exp, (model, _), _, _ = trained
    vis = exp / 'visualization'
    with open(vis / 'ResShift_x4_synthetic_val_4.csv', newline='') as f:
        rows = list(csv.reader(f))
    assert rows[0] == ['', 'psnr', 'ssim']
    assert [r[0] for r in rows[1:]] == ['0', '1']
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    mean_psnr = np.mean([float(r[1]) for r in rows[1:]])
    assert model.best_metric_results['ResShift_x4_synthetic_val']['psnr']['iter'] in (4, 8, 9)
    assert 0 < mean_psnr < 60
    for name in ('lq', 'result', 'gt'):
        img = cv2.imread(str(vis / 'RGB' / 'ResShift_x4_synthetic_val' / '0' / f'{name}.png'))
        assert img is not None and img.shape == ((8, 8, 3) if name == 'lq' else (32, 32, 3))
    assert not (vis / 'NIR').exists()


def test_auto_resume_continues_at_the_saved_iteration(trained):
    _, _, _, (model, steps), _ = trained
    assert [s[0] for s in steps] == [9, 10]
    assert osp.basename(model.opt['path']['pretrain_network_g']) == 'net_g_8.pth'
    state = model.optimizers[0].state_dict()['state']
    assert {int(s['step']) for s in state.values()} == {10}


def test_test_pipeline_samples_every_image(trained):
    root, _, _, _, model = trained
    assert model.output.shape == (1, 3, 32, 32) and torch.isfinite(model.output).all()
    assert set(model.metric_results) == {'psnr', 'ssim'}
    assert all(np.isfinite(v) for v in model.metric_results.values())
    out = root / 'results' / 'test_ResShift_x4_synthetic' / 'visualization'
    assert (out / 'RGB' / 'ResShift_x4_synthetic' / '1' / 'result.png').exists()
    assert (out / 'ResShift_x4_synthetic_test_ResShift_x4_synthetic.csv').exists()


def test_saved_pth_loads_in_the_jax_package_with_the_same_denoiser_output(trained):
    """``net_g_8.pth`` as the port saved it, read by the JAX package's
    ``ResShiftModel`` through its own converter (``params_ema``): one UNet
    forward on the same inputs, within 1e-4 of the largest entry."""
    root, exp, (model, _), _, _ = trained
    opt = yaml_load(TRAIN_CONFIG)
    from basicsr4rs_torch.utils.options import apply_force_yml
    apply_force_yml(opt, SHRINK)
    opt.update(num_gpu=1, is_train=False, dist=False, rank=0, world_size=1)
    for key in ('dims', 'use_fp16'):   # the JAX network does not take BasicSR's two keys
        opt['network_g'].pop(key)
    opt['path'] = {'pretrain_network_g': str(exp / 'models' / 'net_g_8.pth'),
                   'param_key_g': 'params_ema', 'strict_load_g': True,
                   'pretrain_network_ae': None}
    opt.pop('train')
    with mock.patch.object(jax_sr_model, 'jit_init', _shapes_only), \
            mock.patch.object(jax_resshift_model, 'jit_init', _shapes_only):
        jax_model = jax_build_model(opt)   # the UNet's every variable comes from the .pth
    rng = np.random.RandomState(9)
    x = rng.randn(1, 3, 16, 16).astype(np.float32)
    lq = rng.randn(1, 3, 8, 8).astype(np.float32)
    t = np.array([2], np.int32)
    want = jax_model.net_g.apply({'params': jax_model.params}, nhwc(x), jnp.asarray(t),
                                 lq=nhwc(lq))
    net = model.net_g_ema
    ckpt = torch.load(exp / 'models' / 'net_g_8.pth', weights_only=True)['params_ema']
    fresh = UNetModelSwin(**{k: v for k, v in opt['network_g'].items() if k != 'type'})
    fresh.load_state_dict(ckpt)
    got = fresh.eval()(torch.from_numpy(x), torch.from_numpy(t).long(), lq=torch.from_numpy(lq))
    assert_close_rel(got.detach().numpy(), nchw(want), 1e-4)
    assert net.state_dict().keys() == ckpt.keys()


def test_num_gpu_auto_without_a_card_raises_instead_of_running_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this check is about a host without CUDA')
    for entry, config in ((port_train.train_pipeline, TRAIN_CONFIG),
                          (port_test.test_pipeline, TEST_CONFIG)):
        argv = sys.argv
        sys.argv = ['x.py', '-opt', config]
        try:
            with pytest.raises(RuntimeError, match='num_gpu'):
                entry(str(tmp_path))
        finally:
            sys.argv = argv
