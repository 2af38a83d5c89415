"""The slice as a whole on the CPU: DIV2K-style data prepared by the port's
scripts from crops of ``tests/data/baboon.png`` (``extract_subimages`` at
crop 96, step 48; ``generate_bicubic_lr --scale 4``; ``generate_meta_info``),
read by both packages' ``PairedImageDataset`` through the meta-info file,
then ``basicsr4rs_torch.train`` on the published
``options/train/SwinIR/train_SwinIR_SRx4_scratch.yml`` for 2 steps at small
widths. Tolerance: items equal exactly (both packages decode the same files
and draw from generators with the same seed); the loss finite.
"""

import sys
from unittest import mock

import cv2
import numpy as np
import pytest

import basicsr4rs_torch.train as port_train
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.models.swinir_model import SwinIRModel
from basicsr4rs_torch.scripts.data_preparation import extract_subimages, generate_bicubic_lr
from basicsr4rs_torch.scripts.data_preparation import generate_meta_info
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset

CONFIG = 'options/train/SwinIR/train_SwinIR_SRx4_scratch.yml'
BABOON = 'tests/data/baboon.png'
CROP, STEP, SCALE = 96, 48, 4


@pytest.fixture(scope='module')
def prepared(tmp_path_factory):
    """Two HR images (crops of baboon.png, 200x170 and 230x192) through the
    three scripts; two of the sub-images and their LR images copied aside
    as the validation pair."""
    root = tmp_path_factory.mktemp('prepared')
    img = cv2.imread(BABOON)
    (root / 'HR').mkdir()
    cv2.imwrite(str(root / 'HR' / '0001.png'), img[:200, :170])
    cv2.imwrite(str(root / 'HR' / '0002.png'), img[250:, 300:])
    sub, lr = root / 'HR_sub', root / 'LR_bicubic_X4_sub'
    extract_subimages.main(['--input', str(root / 'HR'), '--output', str(sub), '--crop-size',
                            str(CROP), '--step', str(STEP), '--n-thread', '1'])
    generate_bicubic_lr.main(['--input', str(sub), '--output', str(lr), '--scale', str(SCALE)])
    generate_meta_info.main(['--input', str(sub), '--output', str(root / 'meta_info_sub.txt')])
    for folder, src in (('val_GT', sub), ('val_LQ', lr)):
        (root / folder).mkdir()
        for name in ('0001_s001.png', '0002_s004.png'):
            (root / folder / name).write_bytes((src / name).read_bytes())
    return root


def test_prepared_layout(prepared):
    """The crop rule's count (rows 0, 48, 96, 104 by columns 0, 48, 74 of
    0001; rows 0, 48, 96, 134 by columns 0, 48, 96 of 0002), LR at a quarter
    of each side, one sorted meta-info line per sub-image."""
    names = sorted(p.name for p in (prepared / 'HR_sub').iterdir())
    assert len(names) == 4 * 3 + 4 * 3
    for name in names:
        assert cv2.imread(str(prepared / 'HR_sub' / name)).shape == (CROP, CROP, 3)
        assert cv2.imread(str(prepared / 'LR_bicubic_X4_sub' / name)).shape == (
            CROP // SCALE, CROP // SCALE, 3)
    assert (prepared / 'meta_info_sub.txt').read_text() == ''.join(
        f'{name} ({CROP},{CROP},3)\n' for name in names)


def train_opt(prepared):
    opt = yaml_load(CONFIG)['datasets']['train']
    opt.update(phase='train', scale=SCALE, gt_size=32, manual_seed=4,
               dataroot_gt=str(prepared / 'HR_sub'),
               dataroot_lq=str(prepared / 'LR_bicubic_X4_sub'),
               meta_info_file=str(prepared / 'meta_info_sub.txt'))
    return opt


def test_paired_dataset_reads_the_prepared_data_as_jax(prepared):
    """The published training set's options (hflip, rot, the meta-info
    file) on the prepared folders: every item twice, equal."""
    opt = train_opt(prepared)
    port, ref = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert port.paths == ref.paths and len(port) == 24
    for _ in range(2):
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert got['gt_path'] == want['gt_path'] and got['lq_path'] == want['lq_path']
            for key in ('lq', 'gt'):
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]).transpose(2, 0, 1))
    assert port[0]['gt'].shape == (3, 32, 32) and port[0]['lq'].shape == (3, 8, 8)


def test_train_published_config_on_prepared_data(prepared):
    """Two steps of the published SwinIR-M x4 config cut to 2 RSTBs of 2
    blocks at width 24, on the CPU, then one validation on the held-out
    pair: finite losses and a finite PSNR."""
    force = ['num_gpu=0', f'path:experiments_root={prepared / "experiments"}',
             f'datasets:train:dataroot_gt={prepared / "HR_sub"}',
             f'datasets:train:dataroot_lq={prepared / "LR_bicubic_X4_sub"}',
             f'datasets:train:meta_info_file={prepared / "meta_info_sub.txt"}',
             'datasets:train:gt_size=32', f'datasets:val:dataroot_gt={prepared / "val_GT"}',
             f'datasets:val:dataroot_lq={prepared / "val_LQ"}', 'network_g:depths=[2,2]',
             'network_g:num_heads=[2,2]', 'network_g:embed_dim=24', 'train:total_iter=2',
             'val:val_freq=2', 'logger:print_freq=1', 'logger:save_checkpoint_freq=2',
             'logger:use_tb_logger=false']
    losses = []
    step = SwinIRModel.optimize_parameters

    def recorded(model, current_iter):
        step(model, current_iter)
        losses.append(model.get_current_log()['l_pix'])

    argv = sys.argv
    sys.argv = ['train.py', '-opt', CONFIG, '--force_yml', *force]
    try:
        with mock.patch.object(SwinIRModel, 'optimize_parameters', recorded):
            model = port_train.train_pipeline('.')
    finally:
        sys.argv = argv
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    # the published batch, loader workers and Adam stay as they are
    train = model.opt['datasets']['train']
    assert (train['batch_size_per_gpu'], train['num_worker_per_gpu']) == (4, 6)
    assert model.opt['train']['optim_g']['lr'] == 2e-4 and model.opt['network_g']['embed_dim'] == 24
    psnr = model.best_metric_results['Set5']['psnr']['val']
    assert np.isfinite(psnr)
