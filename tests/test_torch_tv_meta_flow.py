"""Small parts of the image-SR path against the JAX package, on the CPU:
``WeightedTVLoss`` (basicsr4rs_torch/losses/basic_loss.py), the meta-info
mode of ``PairedImageDataset`` (data/paired_image_dataset.py,
``data_util.paired_paths_from_meta_info_file``), ``utils/flow_util.py`` and
``utils/plot_util.py``. Inputs from seeded numpy generators.

Tolerances: the loss within 1e-6 relative (float32 sums in another order);
items, paths, files and quantised flows equal.
"""

import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.losses import build_loss
from basicsr4rs_torch.utils import flow_util, plot_util
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.losses.basic_loss import WeightedTVLoss as JaxWeightedTVLoss
from basicsr4rs_tpu.utils import flow_util as jax_flow_util
from basicsr4rs_tpu.utils import plot_util as jax_plot_util


@pytest.mark.parametrize('reduction', ['mean', 'sum'])
@pytest.mark.parametrize('weighted', [False, True], ids=['plain', 'weighted'])
def test_weighted_tv_loss_matches_jax(reduction, weighted):
    rng = np.random.default_rng(int(weighted))
    pred = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    weight = rng.random((2, 1, 9, 11)).astype(np.float32) if weighted else None
    loss = build_loss({'type': 'WeightedTVLoss', 'loss_weight': 0.5, 'reduction': reduction})
    got = loss(torch.from_numpy(pred),
               weight=None if weight is None else torch.from_numpy(weight)).item()
    want = JaxWeightedTVLoss(loss_weight=0.5, reduction=reduction)(
        jnp.asarray(pred.transpose(0, 2, 3, 1)),
        weight=None if weight is None else jnp.asarray(weight.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_weighted_tv_loss_refuses_no_reduction():
    with pytest.raises(ValueError):
        build_loss({'type': 'WeightedTVLoss', 'reduction': 'none'})


def write_pairs(root, rng):
    """GT images ``gt/0.png``, ``gt/sub/1.png`` (not listed: ``gt/2.png``)
    and their x2 LQ as ``lq/<name>x2.png``; a meta-info file of GT names
    with their shapes."""
    (root / 'gt' / 'sub').mkdir(parents=True)
    (root / 'lq').mkdir()
    names = ['0.png', 'sub/1.png']
    for name in names + ['2.png']:
        gt = (rng.random((24, 20, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / name), gt)
        stem = name.split('/')[-1][:-4]
        cv2.imwrite(str(root / 'lq' / f'{stem}x2.png'), gt[::2, ::2])
    meta = root / 'meta_info.txt'
    meta.write_text(''.join(f'{n} (24,20,3)\n' for n in names))
    return str(meta)


@pytest.mark.parametrize('phase', ['train', 'val'])
def test_meta_info_pairs_match_jax(tmp_path, phase):
    """The listed GT names only, paired by ``filename_tmpl``; the same
    paths, and the same items (the train phase's crops and flips drawn from
    the same seed)."""
    meta = write_pairs(tmp_path, np.random.default_rng(0))
    opt = {'name': 'pairs', 'type': 'PairedImageDataset', 'phase': phase, 'scale': 2,
           'dataroot_gt': str(tmp_path / 'gt'), 'dataroot_lq': str(tmp_path / 'lq'),
           'meta_info_file': meta, 'filename_tmpl': '{}x2', 'io_backend': {'type': 'disk'},
           'gt_size': 8, 'use_hflip': True, 'use_rot': True, 'manual_seed': 3}
    port, ref = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert port.paths == ref.paths
    assert [p['lq_path'] for p in port.paths] == [str(tmp_path / 'lq' / '0x2.png'),
                                                  str(tmp_path / 'lq' / '1x2.png')]
    for i in range(len(port)):
        got, want = port[i], ref[i]
        for key in ('lq', 'gt'):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]).transpose(2, 0, 1))
        assert got['gt_path'] == want['gt_path']


def test_lmdb_backend_raises_the_gate_without_lmdb(tmp_path, monkeypatch):
    """``io_backend: lmdb`` without the ``lmdb`` package: both packages
    pair the two folders' keys and raise ``ImportError`` at the first item."""
    for name in ('a.lmdb', 'b.lmdb'):
        (tmp_path / name).mkdir()
        (tmp_path / name / 'meta_info.txt').write_text('1.png (8,8,3) 1\n0.png (8,8,3) 1\n')
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    opt = {'name': 'x', 'type': 'PairedImageDataset', 'phase': 'val', 'scale': 2,
           'dataroot_gt': str(tmp_path / 'a.lmdb'), 'dataroot_lq': str(tmp_path / 'b.lmdb'),
           'io_backend': {'type': 'lmdb'}}
    for dataset in (port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))):
        assert dataset.paths == [{'lq_path': '0', 'gt_path': '0'}, {'lq_path': '1', 'gt_path': '1'}]
        with pytest.raises(ImportError, match='lmdb'):
            dataset[0]


def test_flo_files_round_trip_and_read_as_jax(tmp_path):
    flow = np.random.default_rng(1).standard_normal((7, 9, 2)).astype(np.float32)
    path = str(tmp_path / 'a.flo')
    flow_util.flowwrite(flow, path)
    np.testing.assert_array_equal(flow_util.flowread(path), flow)
    np.testing.assert_array_equal(jax_flow_util.flowread(path), flow)
    (tmp_path / 'bad.flo').write_bytes(b'XXXX' + bytes(8))
    with pytest.raises(IOError):
        flow_util.flowread(str(tmp_path / 'bad.flo'))


@pytest.mark.parametrize('concat_axis', [0, 1])
def test_quantized_flows_match_jax(tmp_path, concat_axis):
    """The quantised image equals the JAX package's; reading it back gives
    each value within half a level (the 255 levels over +-0.02 of the width
    and the height)."""
    h, w = 10, 12
    flow = np.random.default_rng(2).uniform(-0.015, 0.015, (h, w, 2)) * [w, h]
    path, jax_path = str(tmp_path / 'q' / 'f.png'), str(tmp_path / 'j' / 'f.png')
    flow_util.flowwrite(flow, path, quantize=True, concat_axis=concat_axis)
    jax_flow_util.flowwrite(flow, jax_path, quantize=True, concat_axis=concat_axis)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(jax_path, cv2.IMREAD_UNCHANGED))
    back = flow_util.flowread(path, quantize=True, concat_axis=concat_axis)
    np.testing.assert_array_equal(back, jax_flow_util.flowread(path, quantize=True,
                                                               concat_axis=concat_axis))
    assert (np.abs(back - flow) <= 0.02 / 255 * np.array([w, h]) + 1e-6).all()


def test_quantize_matches_jax_and_checks_its_arguments():
    arr = np.random.default_rng(3).uniform(-2, 2, 100)
    np.testing.assert_array_equal(flow_util.quantize(arr, -1, 1, 7),
                                  jax_flow_util.quantize(arr, -1, 1, 7))
    np.testing.assert_array_equal(flow_util.dequantize(np.arange(7), -1, 1, 7),
                                  jax_flow_util.dequantize(np.arange(7), -1, 1, 7))
    for bad in ((-1, 1, 1), (1, 1, 5)):
        with pytest.raises(ValueError):
            flow_util.quantize(arr, *bad)
        with pytest.raises(ValueError):
            flow_util.dequantize(arr, *bad)


def test_plot_util_reads_logs_as_jax(tmp_path):
    log = tmp_path / 'train.log'
    log.write_text('iter: 1, l_pix: 0.5\nnoise\niter: 2, l_pix: 0.25\npsnr: 30.1\n')
    two = r'iter: (\d+), l_pix: ([\d.]+)'
    assert plot_util.read_data_from_txt_2v(str(log), two) == ([1, 2], [0.5, 0.25])
    assert (plot_util.read_data_from_txt_2v(str(log), two, step_one=True)
            == jax_plot_util.read_data_from_txt_2v(str(log), two, step_one=True))
    assert plot_util.read_data_from_txt_1v(str(log), r'psnr: ([\d.]+)') == [30.1]
    values = list(np.random.default_rng(4).random(6))
    assert plot_util.smooth_data(values, 0.6) == jax_plot_util.smooth_data(values, 0.6)


def test_plot_util_reads_tensorboard_scalars(tmp_path):
    from torch.utils.tensorboard import SummaryWriter
    with SummaryWriter(str(tmp_path)) as writer:
        for step, value in ((1, 0.5), (3, 0.25)):
            writer.add_scalar('l_pix', value, step)
    event = next(p for p in tmp_path.iterdir() if 'tfevents' in p.name)
    assert plot_util.read_data_from_tensorboard(str(event), 'l_pix') == ([1, 3], [0.5, 0.25])
