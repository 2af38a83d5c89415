"""The synthetic alignment and SRCNN configs through the port's entry points
on the CPU (``num_gpu=0``) at test widths, on a random L2S tree:
``train.py`` on the registration, joint align-diffusion and SRCNN configs (2
iterations, then the validation after the loop, every metric the config
names, LPIPS on random weights), and ``test.py`` on the joint model's test
config with the trained weights."""

import csv
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.models.align_joint_diff_model import AlignJointDiffModel
from basicsr4rs_torch.models.align_single_model import AlignSingleModel
from basicsr4rs_torch.models.srrs_l2s_model import L2SSingleModel
from basicsr4rs_torch.utils.options import yaml_load

from test_torch_align_findings import SYNTHETIC, config
from test_torch_l2s_data import write_l2s_tree
from test_torch_lpips import write_weights


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Several test workers share the host's cores: with torch's default of
    one thread a core each, the small convolutions here crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SOURCES = (('landsat', 100, 100, 20000), ('sentinel', 300, 150, 2900),
           ('sentinel_hm', 300, 150, 2900))
ALIGN_SHRINK = ['num_feat=8', 'num_block=1']
JOINT_SHRINK = (['network_g:unet_args:' + s for s in (
    'model_channels=8', 'channel_mult=[1]', 'num_res_blocks=[1]', 'attention_resolutions=[]',
    'swin_embed_dim=8', 'num_head_channels=4')]
    + [f'network_g:{part}:{s}' for part in ('align_autoencoder_args', 'lr_encoder_args')
       for s in ALIGN_SHRINK])
# training crops smaller than the configs' (validation keeps their GT: the
# registration config's NIQE needs its 216)
MODELS = {'registration': (AlignSingleModel, ['network_g:' + s for s in ALIGN_SHRINK]
                           + ['datasets:train:gt_size=96'], 26),
          'joint': (AlignJointDiffModel, JOINT_SHRINK, 20),
          'srcnn': (L2SSingleModel, ['datasets:train:gt_size=144'], 2)}


def path_of(name):
    phase, folder, stem = SYNTHETIC[name]
    return config(phase, folder, stem + '.yml')


def lpips_paths(name, weights):
    metrics = yaml_load(path_of(name))['val']['metrics']
    return [f'val:metrics:{m}:{key}={value}' for m, opt in metrics.items()
            if opt['type'] == 'calculate_lpips_band' for key, value in weights.items()]


def run_entry(entry, path, force, root):
    argv = sys.argv
    sys.argv = ['x.py', '-opt', path, '--force_yml', *force]
    try:
        return entry(str(root))
    finally:
        sys.argv = argv


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('align')
    tree = write_l2s_tree(str(root / 'l2s'), tiles=(('tileA', 3), ('tileB', 3)),
                          sources=SOURCES)
    weights = write_weights(root, 0)
    out = {}
    for name, (model_cls, shrink, _) in MODELS.items():
        force = ['num_gpu=0', f'path:experiments_root={root / "exp"}', 'train:total_iter=2',
                 'logger:save_checkpoint_freq=2', 'datasets:train:batch_size_per_gpu=2',
                 'datasets:train:num_worker_per_gpu=0', f'datasets:train:root_path={tree}',
                 f'datasets:val:root_path={tree}'] + shrink + lpips_paths(name, weights)
        logs = []
        step = model_cls.optimize_parameters

        def recorded(model, current_iter, _step=step, _logs=logs):
            _step(model, current_iter)
            _logs.append(model.get_current_log())

        with mock.patch.object(model_cls, 'optimize_parameters', recorded):
            model = run_entry(port_train.train_pipeline, path_of(name), force, root)
        out[name] = (model, logs, root / 'exp' / model.opt['name'])
    trained = out['joint'][2] / 'models' / 'net_g_2.pth'
    force = ['num_gpu=0', f'path:results_root={root / "res"}', f'datasets:test_1:root_path={tree}',
             f'path:pretrain_network_g={trained}', 'path:param_key_g=params_ema'] + JOINT_SHRINK
    out['joint-test'] = run_entry(port_test.test_pipeline, path_of('joint-test'),
                                  force + lpips_paths('joint-test', weights), root)
    return out


@pytest.mark.parametrize('name', list(MODELS))
def test_synthetic_configs_train_and_validate_on_the_cpu(runs, name):
    model, logs, exp = runs[name]
    model_cls, _, metrics = MODELS[name]
    assert type(model) is model_cls and model.device.type == 'cpu' and len(logs) == 2
    assert all(np.isfinite(v) for log in logs for v in log.values()), logs
    assert (exp / 'models' / 'net_g_2.pth').exists()
    (path,) = (exp / 'visualization').glob('*.csv')
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    assert len(rows[0]) == metrics + 1 and len(rows) > 1
    assert all(np.isfinite(float(v)) for row in rows[1:] for v in row[1:])
    gt = model.opt['datasets']['val']['gt_size']
    assert model.output.shape == (1, 6, gt, gt) and torch.isfinite(model.output).all()
    for group in ('RGB', 'NSS'):
        assert any((exp / 'visualization' / group).rglob('result.png')), group


def test_joint_test_config_samples_the_trained_weights_on_the_cpu(runs):
    tested = runs['joint-test']
    assert tested.output.shape == (1, 6, 66, 66) and torch.isfinite(tested.output).all()
    assert len(tested.metric_results) == 20
    assert all(np.isfinite(v) for v in tested.metric_results.values())
