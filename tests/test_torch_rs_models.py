"""The port's remote-sensing models (basicsr4rs_torch/models/srrs_l2s_model.py,
srrs_l2shm_model.py, swinir_model.py's RS variants, resshift_l2s_model.py,
archs/swinir_stylecnn_arch.py) against the JAX package's, from one ``.pth``
on the same batches of the synthetic L2S tree: the fed batches, ``test()``
and the pixel loss of one step of SwinIR-L2S's block at window 6 (36
tokens, shifted by 3) with 6 bands at x3, and ResShift-L2S's feed and
first-stage round trip; validation's CSV and band PNGs; the four synthetic
L2S configs through ``train.py`` and ``test.py``. Everything on the CPU
(``num_gpu: 0``), float32, ``use_amp: false`` (the JAX package's
``use_amp`` only logs a hint).

The JAX ``SRModel`` builds every network on a 32x32 map of 3 bands
(``_dummy_input``), which SwinIR at window 6 with 6 bands cannot take; the
tests give the JAX model a 12x12 map of 6 bands instead."""

import copy
import csv
import os
import sys
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
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.archs.swinir_stylecnn_arch import SwinIR_StyleCNN
from basicsr4rs_torch.data import build_dataloader as port_build_dataloader
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.resshift_l2s_model import ResShiftL2SModel
from basicsr4rs_torch.models.swinir_model import SwinIRL2sModel
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.archs import autoencoder_arch as jax_ae
from basicsr4rs_tpu.archs import swinir_stylecnn_arch as jax_stylecnn
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import resshift_model as jax_resshift_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

from test_torch_l2s_data import l2s_opt, write_l2s_tree
from test_torch_resshift import AE, DIFFUSION, NET as RS_NET, _nonzero_, _shapes_only

ROOT = os.path.join(os.path.dirname(__file__), '..')
CONFIGS = {
    'swinir': (os.path.join(ROOT, 'options', 'train', 'SwinIR', 'train_SwinIR_L2S288_synthetic.yml'),
               os.path.join(ROOT, 'options', 'test', 'SwinIR', 'test_SwinIR_L2S288_synthetic.yml')),
    'resshift': (os.path.join(ROOT, 'options', 'train', 'ResShift',
                              'train_ResShift_L2S288_synthetic.yml'),
                 os.path.join(ROOT, 'options', 'test', 'ResShift',
                              'test_ResShift_L2S288_synthetic.yml')),
}
# SwinIR-L2S's block at test width: one RSTB of a plain and a shifted block,
# embed 12 in 2 heads, window 6 (2x2 windows of the 12x12 LQ), 6 bands, x3
NET = dict(type='SwinIR', img_size=12, patch_size=1, in_chans=6, embed_dim=12, depths=[2],
           num_heads=[2], window_size=6, mlp_ratio=2, upscale=3, img_range=1.0,
           upsampler='pixelshuffle', resi_connection='1conv', drop_path_rate=0.0)
STYLE = dict(in_chans=6, out_chans=6, num_feat=8)
# the JAX SwinIR_StyleCNN has no torch key rules: SwinIR's under sr_net
STYLECNN_TORCH_KEY_RULES = (
    (r'^sr_net\.patch_embed\.norm\.', 'sr_net.patch_embed_norm.'),
    (r'(norm\d*)\.weight$', r'\1.scale'),
    (r'^sr_net\.upsample\.(\d+)\.', lambda m: f'sr_net.upsample.conv{int(m.group(1)) // 2}.'),
)
TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def to_jax_batch(batch):
    """A port batch (NCHW tensors, nested groups) in the JAX layout."""
    return {k: ({g: nhwc(t) for g, t in v.items()} if isinstance(v, dict)
                else nhwc(v) if torch.is_tensor(v) and v.dim() == 4 else v)
            for k, v in batch.items()}


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.), f'{what}: {err}'


@pytest.fixture(scope='module')
def l2s_root(tmp_path_factory):
    return str(write_l2s_tree(str(tmp_path_factory.mktemp('l2s'))))


def model_opt(model_type, network_g, init_path, tmp, **top):
    return {'name': 'rs', 'model_type': model_type, 'scale': 3, 'num_gpu': 0, 'manual_seed': 0,
            'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': copy.deepcopy(network_g),
            'path': {'pretrain_network_g': init_path, 'strict_load_g': True,
                     'visualization': str(tmp / 'vis')},
            'train': {'ema_decay': 0, 'use_amp': False,
                      'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
                      'scheduler': {'type': 'MultiStepLR', 'milestones': [100], 'gamma': 0.5},
                      'total_iter': 10,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0, 'reduction': 'mean'}},
            'val': {'val_freq': 10, 'metrics': {
                'psnr_nir': {'type': 'calculate_psnr_band', 'crop_border': 3, 'band': 3},
                'ssim_red': {'type': 'calculate_ssim_band', 'crop_border': 3, 'band': 0}}},
            **top}


def build_pair(opt):
    """The two packages' models of ``opt``; the JAX one built on a 12x12
    map of 6 bands, reading the port's ``.pth``."""
    port = port_build_model(copy.deepcopy(opt))
    with mock.patch.object(jax_sr_model.SRModel, '_dummy_input',
                           lambda self: jnp.zeros((1, 12, 12, 6), jnp.float32)), \
            mock.patch.object(jax_stylecnn.SwinIR_StyleCNN, 'TORCH_KEY_RULES',
                              STYLECNN_TORCH_KEY_RULES, create=True):
        jax_model = jax_build_model(copy.deepcopy(opt))
    return port, jax_model


def l2s_batch(root, count=2, hm=False):
    """The first ``count`` val items of the tree as one batch; with ``hm``
    the histogram-matched GT of the same samples under ``hm``."""
    opt = l2s_opt(root, phase='val', batch_size_per_gpu=count, num_worker_per_gpu=0)
    batch = next(iter(port_build_dataloader(port_build_dataset(opt), dict(opt, phase='train'),
                                            num_gpu=0)))
    if hm:
        hm_opt = dict(opt, type='L2SSingleHMDataset')
        hm_batch = next(iter(port_build_dataloader(port_build_dataset(hm_opt),
                                                   dict(hm_opt, phase='train'), num_gpu=0)))
        batch['hm'] = hm_batch['gt']
    return batch


@pytest.mark.parametrize('model_type', ['SwinIRL2sModel', 'SwinIRRSModel'])
def test_swinir_rs_models_match_jax(l2s_root, model_type, tmp_path):
    net = _nonzero_(SwinIR(**{k: v for k, v in NET.items() if k != 'type'},
                           generator=torch.Generator().manual_seed(0)), 1)
    init = str(tmp_path / 'init.pth')
    torch.save({'params': net.state_dict()}, init)
    port, jax_model = build_pair(model_opt(model_type, NET, init, tmp_path))
    if model_type == 'SwinIRL2sModel':
        batch = l2s_batch(l2s_root)
    else:   # plain 6-band tensors
        rng = np.random.RandomState(2)
        batch = {'lq': torch.from_numpy(rng.rand(2, 6, 12, 12).astype(np.float32) * 2 - 1),
                 'gt': torch.from_numpy(rng.rand(2, 6, 36, 36).astype(np.float32) * 2 - 1)}
    port.feed_data(batch)
    jax_model.feed_data(to_jax_batch(batch))
    assert port.lq.shape == (2, 6, 12, 12) and port.gt.shape == (2, 6, 36, 36)
    assert_close(nhwc(port.lq), jax_model.batch['lq'], 'lq')
    assert_close(nhwc(port.gt), jax_model.batch['gt'], 'gt (NSS upsampled x2)')

    port.test()
    jax_model.test()
    assert_close(nhwc(port.output), jax_model.output, 'test() output')
    port.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    got, want = port.get_current_log(), jax_model.get_current_log()
    assert list(got) == list(want) == ['l_pix']
    assert got['l_pix'] == pytest.approx(want['l_pix'], rel=TOL)


def test_swinir_hm_model_matches_jax(l2s_root, tmp_path):
    """Both branches of ``SwinIR_StyleCNN`` through ``SwinIRHMModel``, on a
    batch that carries ``hm``: the two losses, their weighted sum and both
    outputs of ``test()``."""
    network_g = {'type': 'SwinIR_StyleCNN',
                 'sr_net_args': {k: v for k, v in NET.items() if k != 'type'},
                 'style_net_args': dict(STYLE)}
    net = _nonzero_(SwinIR_StyleCNN(network_g['sr_net_args'], STYLE,
                                    generator=torch.Generator().manual_seed(0)), 2)
    init = str(tmp_path / 'init.pth')
    torch.save({'params': net.state_dict()}, init)
    port, jax_model = build_pair(model_opt('SwinIRHMModel', network_g, init, tmp_path,
                                           hm_loss_weight=0.9, gt_loss_weight=0.1))
    # the JAX parameters it read carry back under the port's key rules
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jax_model.params))
    back = jax_params_to_state_dict(tree, SwinIR_StyleCNN.JAX_KEY_RULES)
    want = net.state_dict()
    assert back.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)
    batch = l2s_batch(l2s_root, hm=True)
    port.feed_data(batch)
    jax_model.feed_data(to_jax_batch(batch))
    for key in ('lq', 'gt', 'hm'):
        assert_close(nhwc(getattr(port, key)), jax_model.batch[key], key)
    port.test()
    jax_model.test()
    assert_close(nhwc(port.output), jax_model.output, 'output (gt branch)')
    assert_close(nhwc(port.output_hm), jax_model.output_hm, 'output_hm')
    assert not torch.equal(port.output, port.output_hm)
    port.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    got, want = port.get_current_log(), jax_model.get_current_log()
    assert list(got) == list(want) == ['l_pix_hm', 'l_pix_gt']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL), key


def test_resshift_l2s_feed_and_first_stage_match_jax(l2s_root, tmp_path):
    """``ResShiftL2SModel``'s fed batch, and the frozen first stage's round
    trip of its 6 bands (encoded and decoded 3 at a time) against the JAX
    package's on the same weights."""
    stage = _nonzero_(VQModelTorch(**{k: v for k, v in AE.items() if k != 'type'}), 3)
    net_g = dict(RS_NET, in_channels=6, out_channels=6, image_size=18, lq_size=18,
                 attention_resolutions=[18, 9], window_size=3)
    diffusion = dict(DIFFUSION, sf=3)
    opt = model_opt('ResShiftL2SModel', net_g, None, tmp_path, autoencoder=copy.deepcopy(AE),
                    diffusion=diffusion)
    opt['path']['pretrain_network_ae'] = None
    port = port_build_model(copy.deepcopy(opt))
    port.first_stage.load_state_dict(stage.state_dict())
    # the JAX networks' variables as zeros of their shapes (the first stage's
    # come next; the UNet is not run here)
    with mock.patch.object(jax_sr_model, 'jit_init', _shapes_only), \
            mock.patch.object(jax_resshift_model, 'jit_init', _shapes_only):
        jax_model = jax_build_model(copy.deepcopy(opt))
    jax_model.first_stage.params = jax.tree_util.tree_map(jnp.asarray, convert_torch_state_dict(
        stage.state_dict(), rules=jax_ae.VQModelTorch.TORCH_KEY_RULES))
    batch = l2s_batch(l2s_root)
    port.feed_data(batch)
    jax_model.feed_data(to_jax_batch(batch))
    assert port.lq.shape == (2, 6, 12, 12) and port.gt.shape == (2, 6, 36, 36)
    assert port.tt is None and port.noise is None
    assert_close(nhwc(port.lq), jax_model.batch['lq'], 'lq')
    assert_close(nhwc(port.gt), jax_model.batch['gt'], 'gt')

    with torch.no_grad():
        z = port.base_diffusion.encode_first_stage(port.gt, port.first_stage)
        back = port.base_diffusion.decode_first_stage(z, port.first_stage)
        z_lq = port.base_diffusion.encode_first_stage(port.lq, port.first_stage, up_sample=True)
    diffusion, first_stage = jax_model.base_diffusion, jax_model.first_stage

    @jax.jit   # one compilation: op by op the VQ autoencoder takes a minute here
    def round_trip(gt, lq):
        z = diffusion.encode_first_stage(gt, first_stage)
        return (z, diffusion.decode_first_stage(z, first_stage),
                diffusion.encode_first_stage(lq, first_stage, up_sample=True))

    jz, jback, jz_lq = round_trip(jax_model.batch['gt'], jax_model.batch['lq'])
    assert z.shape == (2, 6, 18, 18) and z_lq.shape == (2, 6, 18, 18)
    assert_close(nhwc(z), jz, 'latent of the GT')
    assert_close(nhwc(z_lq), jz_lq, 'latent of the x3 LQ')
    assert_close(nhwc(back), jback, 'decoded GT')


def test_validation_writes_the_csv_and_the_rgb_and_nss_pngs(l2s_root, tmp_path):
    net = SwinIR(**{k: v for k, v in NET.items() if k != 'type'},
                 generator=torch.Generator().manual_seed(0))
    init = str(tmp_path / 'init.pth')
    torch.save({'params': net.state_dict()}, init)
    model = port_build_model(model_opt('SwinIRL2sModel', NET, init, tmp_path))
    val_opt = l2s_opt(l2s_root, 'L2SSingleSplitDataset', split_percent=[0.5, 0.5], split=1)
    loader = port_build_dataloader(port_build_dataset(val_opt), val_opt, num_gpu=0)
    model.nondist_validation(loader, 10, None, save_img=True)
    vis = tmp_path / 'vis'
    with open(vis / 'L2S_10.csv', newline='') as f:
        rows = list(csv.reader(f))
    assert rows[0] == ['', 'psnr_nir', 'ssim_red']
    assert len(rows) == 3 and all(r[0].startswith('tile') for r in rows[1:])
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    name = rows[1][0]
    for group, size in (('RGB', 3), ('NSS', 3)):
        for key, hw in (('lq', 12), ('result', 36), ('gt', 36)):
            path = vis / group / 'L2S' / name / f'{key}.png'
            img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
            assert img is not None and img.shape == (hw, hw, size), path
    assert not (vis / 'NIR').exists()


# ------------------------------------------------------------- the pipelines
# test widths: SwinIR one RSTB of 2 blocks at embed 12 in 2 heads (window 6
# kept); ResShift a two-level UNet of width 8 behind an f2 first stage, 4
# steps; GT 216 (LQ 72), so that NIQE sees 2x2 blocks of 96 after the border
SWINIR_SHRINK = ['num_gpu=0', 'network_g:depths=[2]', 'network_g:num_heads=[2]',
                 'network_g:embed_dim=12', 'datasets:train:gt_size=216',
                 'datasets:train:batch_size_per_gpu=2', 'datasets:train:num_worker_per_gpu=0']
RESSHIFT_SHRINK = ['num_gpu=0', 'network_g:image_size=36', 'network_g:lq_size=36',
                   'network_g:model_channels=8', 'network_g:channel_mult=[1,2]',
                   'network_g:num_res_blocks=[1,1]', 'network_g:attention_resolutions=[36,18]',
                   'network_g:swin_embed_dim=8', 'network_g:num_head_channels=4',
                   'autoencoder:n_embed=16', 'autoencoder:ddconfig:ch=8',
                   'autoencoder:ddconfig:ch_mult=[1,2]', 'autoencoder:ddconfig:num_res_blocks=1',
                   'autoencoder:ddconfig:resolution=72', 'diffusion:steps=4',
                   'diffusion:min_noise_level=0.2']
RESSHIFT_TRAIN = ['datasets:train:gt_size=72', 'datasets:train:batch_size_per_gpu=2',
                  'datasets:train:num_worker_per_gpu=0', 'datasets:val:gt_size=72',
                  'train:warmup_iter=-1']
# the synthetic tree at the sizes chip_smoke.py writes: Landsat 100x100,
# Sentinel RGB 300x300 and NSS 150x150
FULL_SOURCES = (('landsat', 100, 100, 20000), ('sentinel', 300, 150, 2900),
                ('sentinel_hm', 300, 150, 2900))


def run_entry(entry, config, force, root):
    argv = sys.argv
    sys.argv = ['x.py', '-opt', config, '--force_yml', *force]
    try:
        return entry(str(root))
    finally:
        sys.argv = argv


@pytest.fixture(scope='module')
def pipelines(tmp_path_factory):
    """Each L2S config through ``train_pipeline`` (4 iterations, validation
    and a checkpoint at 4), then its test config through ``test_pipeline``
    on the trained ``net_g_4.pth``."""
    root = tmp_path_factory.mktemp('pipelines')
    tree = write_l2s_tree(str(root / 'l2s'), tiles=(('tileA', 3), ('tileB', 3)),
                          sources=FULL_SOURCES)
    runs = {}
    for name, (train_cfg, test_cfg) in CONFIGS.items():
        common = [f'datasets:train:root_path={tree}', 'train:total_iter=4', 'val:val_freq=4',
                  'logger:save_checkpoint_freq=4', f'path:experiments_root={root / "exp"}']
        shrink = SWINIR_SHRINK if name == 'swinir' else RESSHIFT_SHRINK + RESSHIFT_TRAIN
        val_root = [f'datasets:val:root_path={tree}']
        if name == 'swinir':
            val_root.append('datasets:val:gt_size=216')
        steps = []
        model_cls = SwinIRL2sModel if name == 'swinir' else ResShiftL2SModel
        step = model_cls.optimize_parameters

        def recorded(model, current_iter, _step=step, _steps=steps):
            _step(model, current_iter)
            _steps.append(dict(model.get_current_log()))

        with mock.patch.object(model_cls, 'optimize_parameters', recorded):
            trained = run_entry(port_train.train_pipeline, train_cfg,
                                shrink + common + val_root, root)
        exp = root / 'exp' / trained.opt['name']
        test_force = [f'datasets:test_1:root_path={tree}', f'path:results_root={root / "res"}',
                      f'path:pretrain_network_g={exp / "models" / "net_g_4.pth"}',
                      'path:param_key_g=params_ema']
        if name == 'swinir':
            test_force += ['num_gpu=0', 'network_g:depths=[2]', 'network_g:num_heads=[2]',
                           'network_g:embed_dim=12', 'datasets:test_1:gt_size=216']
        else:
            ae_path = root / 'autoencoder.pth'
            torch.save({'params': trained.first_stage.state_dict()}, ae_path)
            test_force += RESSHIFT_SHRINK + [f'path:pretrain_network_ae={ae_path}',
                                             'datasets:test_1:gt_size=72']
        tested = run_entry(port_test.test_pipeline, test_cfg, test_force, root)
        runs[name] = (exp, trained, steps, tested)
    return runs


@pytest.mark.parametrize('name', list(CONFIGS))
def test_synthetic_configs_train_validate_and_serve_on_the_cpu(pipelines, name):
    exp, trained, steps, tested = pipelines[name]
    assert len(steps) == 4 and trained.device.type == 'cpu'
    key = 'l_pix' if name == 'swinir' else 'loss'
    assert all(np.isfinite(s[key]) for s in steps)
    assert (exp / 'models' / 'net_g_4.pth').exists()
    csvs = sorted(p.name for p in (exp / 'visualization').glob('*.csv'))
    assert csvs, 'no per-image metric CSV'
    metrics = trained.metric_results
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
    if name == 'swinir':   # the band metrics and NIQE the config names
        assert {'psnr_nir', 'ssim_swir22', 'niqe_red', 'niqe_swir16'} <= set(metrics)
    for group in ('RGB', 'NSS'):
        assert any((exp / 'visualization' / group).rglob('result.png')), group
    assert tested.output.shape[1] == 6 and torch.isfinite(tested.output).all()
    assert all(np.isfinite(v) for v in tested.metric_results.values())


@pytest.mark.parametrize('which', [0, 1], ids=['train', 'test'])
@pytest.mark.parametrize('name', list(CONFIGS))
def test_synthetic_configs_parse_and_refuse_num_gpu_auto_without_a_card(name, which, tmp_path):
    config = CONFIGS[name][which]
    opt = yaml_load(config)
    assert opt['num_gpu'] == 'auto' and opt['scale'] == 3
    datasets = [d for d in opt['datasets'].values()]
    for d in datasets:
        assert d['type'] in ('L2SSingleHMSplitDataset', 'L2SSingleSplitDataset')
        assert {'psnr_min', 'ssim_min', 'psnr_max'} <= set(d)
    if torch.cuda.is_available():
        pytest.skip('the refusal is about a host without CUDA')
    entry = port_train.train_pipeline if which == 0 else port_test.test_pipeline
    argv = sys.argv
    sys.argv = ['x.py', '-opt', config]
    try:
        with pytest.raises(RuntimeError, match='num_gpu'):
            entry(str(tmp_path))
    finally:
        sys.argv = argv
