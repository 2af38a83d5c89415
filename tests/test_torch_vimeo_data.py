"""The port's Vimeo90K and DUF data path (``data_util.duf_downsample``,
``generate_gaussian_kernel``, ``Vimeo90KDataset``,
``Vimeo90KRecurrentDataset``, ``VideoTestVimeo90KDataset``,
``VideoTestDUFDataset``) against the JAX package's, item by item, on PNG
septuplets and clips written to ``tmp_path``. Both packages decode the same
files and draw from generators with the same seed, so the arrays are equal
exactly: the port's (T, C, H, W) are the JAX package's (T, H, W, C)
transposed."""

import cv2
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.data import data_util as port_util
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.data import data_util as jax_util

from test_torch_video_data import assert_same_item, to_port_layout

SEQS = ['00001/0001', '00001/0002', '00002/0001']
LQ, SCALE = (12, 16), 4


@pytest.fixture(scope='module')
def vimeo(tmp_path_factory):
    """Septuplets ``<root>/{GT,LQ}/<clip>/<seq>/im1..7.png`` and a
    meta-info file that lists them."""
    root = tmp_path_factory.mktemp('vimeo')
    rng = np.random.RandomState(0)
    for seq in SEQS:
        for sub, (h, w) in (('GT', (LQ[0] * SCALE, LQ[1] * SCALE)), ('LQ', LQ)):
            (root / sub / seq).mkdir(parents=True)
            for i in range(1, 8):
                cv2.imwrite(str(root / sub / seq / f'im{i}.png'),
                            (rng.rand(h, w, 3) * 255).astype(np.uint8))
    (root / 'meta.txt').write_text(''.join(f'{seq} 7 (48,64,3)\n' for seq in SEQS))
    return root


@pytest.fixture(scope='module')
def vid(tmp_path_factory):
    """One GT clip of 5 frames of 40x52 (not a multiple of 4: the DUF set
    crops it) and its LQ, ``<root>/{GT,LQ}/calendar/0000000i.png``."""
    root = tmp_path_factory.mktemp('vid')
    rng = np.random.RandomState(1)
    for sub, (h, w) in (('GT', (40, 52)), ('LQ', (10, 13))):
        (root / sub / 'calendar').mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(root / sub / 'calendar' / f'{i:08d}.png'),
                        (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return root


def _vimeo_opt(root, cls, **extra):
    opt = dict(name='vimeo', type=cls, phase='train', scale=SCALE, num_frame=5,
               dataroot_gt=str(root / 'GT'), dataroot_lq=str(root / 'LQ'),
               meta_info_file=str(root / 'meta.txt'), io_backend={'type': 'disk'}, gt_size=32,
               random_reverse=False, use_hflip=True, use_rot=True, manual_seed=3)
    opt.update(extra)
    return opt


@pytest.mark.parametrize('extra', [
    dict(), dict(num_frame=3, random_reverse=True), dict(num_frame=7, use_rot=False),
], ids=['five-frames', 'three-reversed', 'seven-frames'])
def test_vimeo90k_dataset_items(vimeo, extra):
    """Two passes over the keys: the generators stay in step."""
    opt = _vimeo_opt(vimeo, 'Vimeo90KDataset', **extra)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert got.keys == want.keys == SEQS
    for _ in range(2):
        for i in range(len(want)):
            assert_same_item(got[i], want[i])
    item = got[0]
    assert item['lq'].shape == (opt['num_frame'], 3, 8, 8) and item['gt'].shape == (3, 32, 32)


@pytest.mark.parametrize('flip', [False, True], ids=['seven', 'flip-sequence'])
def test_vimeo90k_recurrent_dataset_items(vimeo, flip):
    opt = _vimeo_opt(vimeo, 'Vimeo90KRecurrentDataset', num_frame=-1, flip_sequence=flip)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    for _ in range(2):
        for i in range(len(want)):
            assert_same_item(got[i], want[i])
    item = got[1]
    frames = 14 if flip else 7
    assert item['lq'].shape == (frames, 3, 8, 8) and item['gt'].shape == (frames, 3, 32, 32)
    if flip:   # the second half is the first reversed
        assert torch.equal(item['lq'][7:], item['lq'][:7].flip(0))
        assert torch.equal(item['gt'][7:], item['gt'][:7].flip(0))


def test_vimeo90k_lmdb_keeps_the_import_gate(vimeo):
    """``lmdb`` is not installed: the LMDB backend raises where it is made,
    in both packages."""
    opt = _vimeo_opt(vimeo, 'Vimeo90KDataset', io_backend={'type': 'lmdb'})
    for build in (port_build_dataset, jax_build_dataset):
        dataset = build(opt)
        with pytest.raises(ImportError, match='lmdb'):
            dataset[0]


def test_video_test_vimeo90k_dataset_items(vimeo):
    opt = dict(name='vimeo', type='VideoTestVimeo90KDataset', phase='val', scale=SCALE,
               num_frame=7, dataroot_gt=str(vimeo / 'GT'), dataroot_lq=str(vimeo / 'LQ'),
               meta_info_file=str(vimeo / 'meta.txt'), io_backend={'type': 'disk'},
               cache_data=False)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert len(got) == len(want) == 3
    assert got.data_info == want.data_info
    for i in range(3):
        assert_same_item(got[i], want[i])
    assert got[2]['lq_path'].endswith('00002/0001/im4.png')
    assert got[0]['lq'].shape == (7, 3, *LQ)
    with pytest.raises(NotImplementedError, match='cache_data'):
        port_build_dataset(dict(opt, cache_data=True))


@pytest.mark.parametrize('extra', [
    dict(use_duf_downsampling=True), dict(use_duf_downsampling=True, cache_data=True),
    dict(use_duf_downsampling=False), dict(use_duf_downsampling=False, cache_data=True),
], ids=['duf', 'duf-cached', 'lq', 'lq-cached'])
def test_video_test_duf_dataset_items(vid, extra):
    opt = dict(name='vid', type='VideoTestDUFDataset', phase='val', scale=SCALE, num_frame=5,
               dataroot_gt=str(vid / 'GT'), dataroot_lq=str(vid / 'LQ'),
               io_backend={'type': 'disk'}, padding='reflection_circle', cache_data=False)
    opt.update(extra)
    got, want = port_build_dataset(opt), jax_build_dataset(opt)
    assert len(got) == len(want) == 5
    for i in range(5):
        item, ref = got[i], want[i]
        assert item.keys() == ref.keys()
        for key in ('folder', 'idx', 'border', 'lq_path'):
            assert item[key] == ref[key], key
        for key in ('lq', 'gt'):
            assert item[key].dtype == torch.float32
            np.testing.assert_array_equal(item[key].numpy(), to_port_layout(ref[key]),
                                          err_msg=key)
    if extra['use_duf_downsampling']:
        assert got[0]['lq'].shape == (5, 3, 10, 13)
        assert got[0]['gt'].shape == (3, 40, 52)


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_duf_downsample(scale):
    rng = np.random.RandomState(scale)
    frames = rng.rand(3, 36, 48, 3).astype(np.float32)
    want = jax_util.duf_downsample(frames, kernel_size=13, scale=scale)
    got = port_util.duf_downsample(torch.from_numpy(frames.transpose(0, 3, 1, 2)), 13, scale)
    assert torch.is_tensor(got) and got.shape == (3, 3, 36 // scale, 48 // scale)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    one = port_util.duf_downsample(frames[0].transpose(2, 0, 1), 13, scale)   # (C, H, W), numpy
    np.testing.assert_array_equal(one, want[0].transpose(2, 0, 1))
    np.testing.assert_array_equal(port_util.generate_gaussian_kernel(13, 0.4 * scale),
                                  jax_util.generate_gaussian_kernel(13, 0.4 * scale))
    with pytest.raises(ValueError, match='scale'):
        port_util.duf_downsample(frames, 13, 5)
