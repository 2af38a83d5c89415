"""The port's video data path (``data_util.read_img_seq``,
``generate_frame_indices``, ``VideoTestDataset``,
``VideoRecurrentTestDataset``, ``REDSDataset``, ``REDSRecurrentDataset``)
against the JAX package's classes, item by item, on PNG clips written to
``tmp_path``. Both packages decode the same files and draw from generators
with the same seed, so tensors are equal exactly: the port's (T, C, H, W)
are the JAX package's (T, H, W, C) transposed."""

import sys

import cv2
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import build_dataloader as port_build_dataloader
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.data import data_util as port_util
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.data import data_util as jax_util

CLIPS = {'100': 7, '101': 5, '011': 6}   # 011 is a REDS4 validation clip
LQ, SCALE = (12, 16), 4


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """GT and LQ clips, a training meta-info file that lists all three and a
    test one that lists two."""
    root = tmp_path_factory.mktemp('clips')
    rng = np.random.RandomState(0)
    for clip, frames in CLIPS.items():
        for sub, (h, w) in (('GT', (LQ[0] * SCALE, LQ[1] * SCALE)), ('LQ', LQ)):
            (root / sub / clip).mkdir(parents=True)
            for i in range(frames):
                cv2.imwrite(str(root / sub / clip / f'{i:08d}.png'),
                            (rng.rand(h, w, 3) * 255).astype(np.uint8))
    (root / 'meta_train.txt').write_text(''.join(
        f'{clip} {frames} ({LQ[0] * SCALE},{LQ[1] * SCALE},3)\n' for clip, frames in CLIPS.items()))
    (root / 'meta_test.txt').write_text('101 5 (48,64,3)\n100 7 (48,64,3)\n')
    return root


def to_port_layout(a):
    """The JAX package's (..., H, W, C) as the port's (..., C, H, W)."""
    return np.moveaxis(np.asarray(a), -1, -3)


def assert_same_item(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert torch.is_tensor(got[key]) and got[key].dtype == torch.float32, key
            np.testing.assert_array_equal(got[key].numpy(), to_port_layout(value), err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize('padding', ['replicate', 'reflection', 'reflection_circle', 'circle'])
def test_generate_frame_indices(padding):
    for max_frame_num, num_frames in ((7, 5), (5, 5), (9, 3), (12, 7)):
        for crt in range(max_frame_num):
            assert (port_util.generate_frame_indices(crt, max_frame_num, num_frames, padding)
                    == jax_util.generate_frame_indices(crt, max_frame_num, num_frames, padding))


def test_generate_frame_indices_rejects_bad_arguments():
    with pytest.raises(ValueError, match='odd'):
        port_util.generate_frame_indices(0, 7, 4)
    with pytest.raises(ValueError, match='padding'):
        port_util.generate_frame_indices(0, 7, 5, padding='mirror')


def test_read_img_seq(clips):
    folder = str(clips / 'GT' / '100')
    got, names = port_util.read_img_seq(folder, return_imgname=True)
    want, want_names = jax_util.read_img_seq(folder, return_imgname=True)
    assert names == want_names == [f'{i:08d}' for i in range(7)]
    np.testing.assert_array_equal(got.numpy(), to_port_layout(want))
    paths = [str(clips / 'LQ' / '101' / f'{i:08d}.png') for i in (3, 1)]
    got = port_util.read_img_seq(paths, require_mod_crop=True, scale=5)
    want = jax_util.read_img_seq(paths, require_mod_crop=True, scale=5)
    assert got.shape == (2, 3, 10, 15)
    np.testing.assert_array_equal(got.numpy(), to_port_layout(want))


def _test_opt(clips, cls, **extra):
    opt = dict(name='clips', type=cls, phase='val', scale=SCALE, num_frame=5,
               dataroot_gt=str(clips / 'GT'), dataroot_lq=str(clips / 'LQ'),
               io_backend={'type': 'disk'}, padding='reflection_circle', cache_data=False)
    opt.update(extra)
    return opt


@pytest.mark.parametrize('extra', [
    dict(), dict(cache_data=True), dict(padding='replicate', num_frame=3),
    dict(meta_info_file='meta_test.txt'), dict(meta_info_file='meta_test.txt', cache_data=True),
], ids=['folders', 'cached', 'replicate-3', 'meta-info', 'meta-info-cached'])
def test_video_test_dataset_items(clips, extra):
    extra = dict(extra)
    if 'meta_info_file' in extra:
        extra['meta_info_file'] = str(clips / extra['meta_info_file'])
    opt = _test_opt(clips, 'VideoTestDataset', **extra)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert len(got) == len(want) == (12 if 'meta_info_file' in extra else 18)
    assert got.data_info == want.data_info
    for i in range(len(want)):
        assert_same_item(got[i], want[i])


def test_video_test_dataset_through_the_loader(clips):
    """The val loader hands the model batches of one item: tensors with a
    leading 1, strings in lists."""
    opt = _test_opt(clips, 'VideoTestDataset')
    loader = port_build_dataloader(port_build_dataset(opt), opt)
    batch = next(iter(loader))
    assert batch['lq'].shape == (1, 5, 3, *LQ) and batch['gt'].shape == (1, 3, 48, 64)
    assert batch['folder'] == ['011'] and batch['idx'] == ['0/6']
    assert batch['lq_path'][0].endswith('00000000.png')


def test_video_recurrent_test_dataset_items(clips):
    opt = _test_opt(clips, 'VideoRecurrentTestDataset', cache_data=True, num_frame=-1)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_same_item(got[i], want[i])
    assert got[1]['lq'].shape == (7, 3, *LQ)
    with pytest.raises(ValueError, match='cache_data'):
        port_build_dataset(dict(opt, cache_data=False))


def _train_opt(clips, cls, **extra):
    opt = dict(name='clips', type=cls, phase='train', scale=SCALE, num_frame=5,
               dataroot_gt=str(clips / 'GT'), dataroot_lq=str(clips / 'LQ'),
               meta_info_file=str(clips / 'meta_train.txt'), val_partition='REDS4',
               io_backend={'type': 'disk'}, gt_size=32, interval_list=[1],
               random_reverse=False, use_hflip=True, use_rot=True, manual_seed=3)
    opt.update(extra)
    return opt


@pytest.mark.parametrize('extra', [
    dict(), dict(num_frame=3, interval_list=[1, 2], random_reverse=True),
    dict(num_frame=3, use_rot=False),
    dict(test_mode=True, num_frame=3),
], ids=['published', 'interval-reverse', 'three-frames', 'test-mode'])
def test_reds_dataset_items(clips, extra):
    """Two passes over the keys in order: the generators stay in step, so
    every crop, flip and moved window is the same."""
    opt = _train_opt(clips, 'REDSDataset', **extra)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert got.keys == want.keys
    assert len(got) == (6 if extra.get('test_mode') else 12)
    for _ in range(2):
        for i in range(len(want)):
            assert_same_item(got[i], want[i])
    item = got[0]
    assert item['lq'].shape == (opt['num_frame'], 3, 8, 8) and item['gt'].shape == (3, 32, 32)


@pytest.mark.parametrize('extra', [
    dict(num_frame=4), dict(num_frame=2, interval_list=[1, 2], random_reverse=True),
], ids=['four-frames', 'interval-reverse'])
def test_reds_recurrent_dataset_items(clips, extra):
    opt = _train_opt(clips, 'REDSRecurrentDataset', **extra)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert got.keys == want.keys and len(got) == 12
    for _ in range(2):
        for i in range(len(want)):
            assert_same_item(got[i], want[i])
    item = got[0]
    assert item['lq'].shape == (opt['num_frame'], 3, 8, 8)
    assert item['gt'].shape == (opt['num_frame'], 3, 32, 32)


@pytest.mark.parametrize('cls', ['REDSDataset', 'REDSRecurrentDataset'])
def test_reds_datasets_reject_what_is_not_ported(clips, cls, monkeypatch):
    """LMDB mode without ``lmdb`` builds, and raises the gate's
    ``ImportError`` at the first item as the JAX dataset does; an unknown
    validation partition is refused."""
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    opt = _train_opt(clips, cls, io_backend={'type': 'lmdb'})
    for dataset in (port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))):
        with pytest.raises(ImportError, match='lmdb'):
            dataset[0]
    with pytest.raises(ValueError, match='partition'):
        port_build_dataset(_train_opt(clips, cls, val_partition='mine'))


@pytest.mark.parametrize('cls, num_frame', [('REDSDataset', 3), ('REDSRecurrentDataset', 4)])
def test_reds_datasets_take_a_flow_root_in_disk_mode(clips, cls, num_frame):
    """``dataroot_flow`` set (to a folder that does not exist: disk mode
    reads nothing from it, as in the JAX package): every item equals the
    item without it and the JAX dataset's item with it."""
    opt = _train_opt(clips, cls, num_frame=num_frame)
    flow = dict(opt, dataroot_flow=str(clips / 'no_flow_here'))
    plain, got, want = port_build_dataset(opt), port_build_dataset(flow), jax_build_dataset(flow)
    assert got.keys == plain.keys == want.keys
    for i in range(len(want)):
        item, without = got[i], plain[i]
        assert_same_item(item, want[i])
        assert item.keys() == without.keys()
        for key, value in without.items():
            assert torch.equal(item[key], value) if torch.is_tensor(value) else (
                item[key] == value), key


def test_reds_dataset_needs_an_odd_window(clips):
    with pytest.raises(ValueError, match='odd'):
        port_build_dataset(_train_opt(clips, 'REDSDataset', num_frame=4))
