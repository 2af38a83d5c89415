"""The port's models on two gloo ranks against one process, through one
torchrun of ``tests/torch_dist_worker.py`` (its jobs run in order on both
ranks):

* ``VideoRecurrentModel`` (BasicVSR at width 8, one block) validates 3 clips
  through ``basicsr4rs_torch.test --launcher pytorch``: rank 0 takes clips 0
  and 2, rank 1 clip 1 and then clip 2 again without recording it;
* ``EDVRModel`` (EDVR at width 16, 3 frames) validates 7 frame windows of 2
  clips, strided over the ranks;
* ``ResShiftModel`` (the tiny UNet of ``test_torch_resshift.py``) takes 2
  SGD steps, each rank on its half of a global batch of 4 that carries the
  timesteps and the noise;
* the collectives the models use: ``sum_across_processes``,
  ``reduce_loss_dict``, ``barrier``.

The video metrics must be exactly one process's, the padded tail
included; the ResShift UNet and its EMA one process's at the global batch
within float32 rounding."""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from os import path as osp
from unittest import mock

import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
from basicsr4rs_torch.archs.basicvsr_arch import BasicVSR
from basicsr4rs_torch.archs.edvr_arch import EDVR
from basicsr4rs_torch.archs.unet_arch import UNetModelSwin
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.models.video_base_model import VideoBaseModel

from test_torch_resshift import AE, NET, _nonzero_, _opt
from test_torch_video_models import EDVR_SHRINK, EDVR_TEST, write_clips
from torch_dist_worker import torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
WORKER = osp.join(REPO, 'tests', 'torch_dist_worker.py')
BASICVSR_TEST = osp.join(REPO, 'options', 'test', 'BasicVSR', 'test_BasicVSR_REDS_synthetic.yml')
BASICVSR_SHRINK = ['num_gpu=0', 'network_g:num_feat=8', 'network_g:num_block=1']
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)


def video_argv(root, kind, results):
    """The command line of ``basicsr4rs_torch.test`` for ``kind``, its
    results under ``results``."""
    if kind == 'basicvsr':
        return ['-opt', BASICVSR_TEST, '--force_yml', *BASICVSR_SHRINK, 'val:save_img=false',
                f'path:results_root={results}',
                f'path:pretrain_network_g={root / "basicvsr.pth"}',
                f'datasets:test_1:dataroot_gt={root / "clips_GT"}',
                f'datasets:test_1:dataroot_lq={root / "clips_LQ"}']
    return ['-opt', EDVR_TEST, '--force_yml', *EDVR_SHRINK, 'val:save_img=false',
            'datasets:test_1:num_frame=3', f'path:results_root={results}',
            f'path:pretrain_network_g={root / "edvr.pth"}',
            f'datasets:test_1:dataroot_gt={root / "windows_GT"}',
            f'datasets:test_1:dataroot_lq={root / "windows_LQ"}',
            f'datasets:test_1:meta_info_file={root / "meta_info_windows.txt"}']


def one_process_test(argv):
    """``test_pipeline`` in this process (no launcher)."""
    saved = sys.argv
    sys.argv = ['test.py', *argv]
    try:
        with mock.patch.object(VideoBaseModel, 'dist_validation',
                               side_effect=AssertionError('one process must not stride')):
            model = port_test.test_pipeline(REPO)
    finally:
        sys.argv = saved
    return model


def resshift_batches(path):
    rng = np.random.RandomState(3)
    arrays = {}
    for step in range(2):
        arrays.update({f'lq{step}': (rng.rand(4, 3, 8, 8) * 2 - 1).astype(np.float32),
                       f'gt{step}': (rng.rand(4, 3, 32, 32) * 2 - 1).astype(np.float32),
                       f'tt{step}': rng.randint(0, 4, size=(4,)).astype(np.int64),
                       f'noise{step}': rng.randn(4, 3, 16, 16).astype(np.float32)})
    np.savez(path, **arrays)
    return arrays


def one_process_resshift(opt, ae, arrays):
    model = build_model(opt)
    model.first_stage.load_state_dict(torch.load(ae, weights_only=True))
    losses = []
    for step in range(2):
        model.feed_data({k: torch.from_numpy(arrays[f'{k}{step}'])
                         for k in ('lq', 'gt', 'tt', 'noise')})
        model.optimize_parameters(step + 1)
        losses.append(model.get_current_log()['loss'])
    return model, losses


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_models')
    rng = np.random.RandomState(0)
    write_clips(root, {'clips': ({'000': 2, '001': 2, '002': 2}, (64, 64)),
                       'windows': ({'300': 3, '301': 4}, (12, 16))}, rng)
    torch.manual_seed(0)
    torch.save({'params': BasicVSR(8, 1).state_dict()}, root / 'basicvsr.pth')
    torch.save({'params': EDVR(num_feat=16, num_frame=3, deformable_groups=2,
                               num_extract_block=1, num_reconstruct_block=1).state_dict()},
               root / 'edvr.pth')
    unet = _nonzero_(UNetModelSwin(**{k: v for k, v in NET.items() if k != 'type'}), 1)
    torch.save({'params': unet.state_dict()}, root / 'unet.pth')
    stage = _nonzero_(VQModelTorch(**{k: v for k, v in AE.items() if k != 'type'}), 2)
    torch.save(stage.state_dict(), root / 'ae.pth')
    arrays = resshift_batches(root / 'batches.npz')
    opt = _opt('SGD', str(root / 'unet.pth'))

    jobs = [{'kind': 'test', 'name': kind,
             'argv': [*video_argv(root, kind, root / 'ranks'), '--launcher', 'pytorch']}
            for kind in ('basicvsr', 'edvr')]
    jobs += [{'kind': 'resshift', 'name': 'resshift', 'opt': opt, 'ae': str(root / 'ae.pth'),
              'batches': str(root / 'batches.npz'), 'steps': 2},
             {'kind': 'collectives', 'name': 'collectives'}]
    (root / 'jobs.json').write_text(json.dumps(jobs))
    out = root / 'out'
    out.mkdir()
    # one thread here as on each rank: a convolution's sums then split alike,
    # and the 8-bit images that the metrics read come out the same
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(torchrun, 2, WORKER, str(out), str(root / 'jobs.json'))
            one = {kind: one_process_test(video_argv(root, kind, root / 'one'))
                   for kind in ('basicvsr', 'edvr')}
            one['resshift'] = one_process_resshift(opt, str(root / 'ae.pth'), arrays)
            output = ranks.result()
    finally:
        torch.set_num_threads(threads)
    two = {job['name']: torch.load(out / f'{job["name"]}.pt', weights_only=False)
           for job in jobs}
    return dict(one=one, two=two, output=output, root=root)


@pytest.mark.parametrize('kind, rows', [('basicvsr', {'000': 2, '001': 2, '002': 2}),
                                        ('edvr', {'300': 3, '301': 4})])
def test_strided_video_validation_gives_one_process_metrics(runs, kind, rows):
    one, two = runs['one'], runs['two']
    got, want = two[kind]['per_folder'], one[kind].metric_results_per_folder
    assert got.keys() == want.keys()
    for folder, n in rows.items():
        assert got[folder].shape == (n, 1) and np.all(got[folder] > 0)
        np.testing.assert_array_equal(got[folder], want[folder], err_msg=folder)
    assert two[kind]['metrics'] == one[kind].metric_results


def test_padded_tail_is_run_and_not_recorded(runs):
    """3 clips on 2 ranks: rank 1 runs clip 2 again to stay in step; its rows
    are clip 2's alone (a second record would double them)."""
    assert '1 padding folders added to keep validation in step' in runs['output']


def test_resshift_on_two_ranks_is_one_process_at_the_global_batch(runs):
    """The UNet trains wrapped in DDP (the first stage does not), and after 2
    SGD steps its parameters and EMA are one process's at the batch of 4
    within float32 rounding; the logged loss is the global batch's mean."""
    model, losses = runs['one']['resshift']
    got = runs['two']['resshift']
    assert got['wrapped'] == 'DistributedDataParallel' and got['first_stage'] == 'VQModelTorch'
    np.testing.assert_allclose(got['losses'], losses, rtol=1e-5)
    for key, want in (('params', model.net_g.state_dict()), ('ema', model.net_g_ema.state_dict())):
        assert got[key].keys() == want.keys()
        for name, value in got[key].items():
            torch.testing.assert_close(value, want[name], **F32_ROUNDING, msg=f'{key} {name}')
    init = torch.load(runs['root'] / 'unet.pth', weights_only=True)['params']
    assert sum(not torch.equal(v, init[k]) for k, v in got['params'].items()) > len(init) // 2


def test_collectives_merge_and_average_across_ranks(runs):
    got = runs['two']['collectives']
    np.testing.assert_array_equal(got['merged'], np.arange(12, dtype=np.float32).reshape(6, 2))
    assert got['losses'] == {'l_a': 1.5, 'l_b': 5.0}   # the ranks' mean
    assert got['device_info'] == (0, 0)
