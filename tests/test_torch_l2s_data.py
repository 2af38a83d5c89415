"""The port's remote-sensing data path (basicsr4rs_torch/data/transforms.py,
l2s_single_dataset.py, l2s_single_hm_dataset.py,
l2s_single_mean2std_dataset.py, taco_dataset.py) against the JAX package's,
on one synthetic L2S tree of uint16 TIFFs: the same items, bit for bit, in
the val phase and, with the same ``manual_seed``, in the train phase; the
same split; the same import gate. The port's items are CHW tensors, the JAX
package's HWC arrays."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import build_dataloader as port_build_dataloader
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.data import transforms as port_transforms
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.data import transforms as jax_transforms

RGB_BANDS = ('red', 'green', 'blue')
NSS_BANDS = ('nir08', 'swir16', 'swir22')
# (source, RGB size, NSS size, largest digital number): Landsat at 30 m,
# Sentinel's RGB at 10 m and its NSS group at 20 m
SOURCES = (('landsat', 24, 24, 20000), ('sentinel', 72, 36, 2900), ('sentinel_hm', 72, 36, 2900))


def write_l2s_tree(root, tiles=(('tileA', 3), ('tileB', 2)), sources=SOURCES, seed=0):
    """``<root>/<tile>/w<i>/t0/<source>/<band>.tif`` with random digital
    numbers, and per tile a ``metric.json`` and a ``metric_hm.json`` whose
    scores put every window inside the filter of ``l2s_opt`` except the
    last window of the first tile (PSNR 60, over ``psnr_max``)."""
    rng = np.random.RandomState(seed)
    for t, (tile, windows) in enumerate(tiles):
        metrics = {}
        for i in range(windows):
            psnr = 60.0 if (t, i) == (0, windows - 1) else 30.0 + i
            metrics[f'w{i}'] = {'t0': {'psnr': psnr, 'ssim': 0.9}}
            for src, rgb_size, nss_size, top in sources:
                folder = os.path.join(root, tile, f'w{i}', 't0', src)
                os.makedirs(folder, exist_ok=True)
                for bands, size in ((RGB_BANDS, rgb_size), (NSS_BANDS, nss_size)):
                    for band in bands:
                        arr = (rng.rand(size, size) * top).astype(np.uint16)
                        cv2.imwrite(os.path.join(folder, f'{band}.tif'), arr)
        for name in ('metric.json', 'metric_hm.json'):
            with open(os.path.join(root, tile, name), 'w') as f:
                json.dump(metrics, f)
    return root


@pytest.fixture(scope='module')
def l2s_root(tmp_path_factory):
    return str(write_l2s_tree(str(tmp_path_factory.mktemp('l2s'))))


def l2s_opt(root, kind='L2SSingleDataset', phase='val', **extra):
    return {'name': 'L2S', 'type': kind, 'phase': phase, 'scale': 3, 'root_path': root,
            'psnr_min': 20, 'ssim_min': 0.5, 'psnr_max': 50, 'gt_size': 36,
            'use_hflip': True, 'use_rot': True, 'manual_seed': 0, **extra}


def assert_items_equal(got, want):
    """A port item (CHW tensors) against a JAX item (HWC arrays), exactly."""
    for side in ('lq', 'gt'):
        for group in ('rgb', 'nss'):
            g = got[side][group]
            assert torch.is_tensor(g) and g.dtype == torch.float32, (side, group)
            np.testing.assert_array_equal(g.numpy().transpose(1, 2, 0), want[side][group],
                                          err_msg=f'{side} {group}')
    assert got['sample_path'] == want['sample_path']
    assert got['img_name'] == want['img_name']


# --------------------------------------------------------------- transforms
def test_rs_transforms_match_jax():
    rng = np.random.RandomState(1)
    gt = rng.rand(30, 33, 3).astype(np.float32)
    lq = rng.rand(10, 11, 6).astype(np.float32)
    got = port_transforms.paired_central_crop([gt, gt[..., :2]], lq, 24, 3)
    want = jax_transforms.paired_central_crop([gt, gt[..., :2]], lq, 24, 3)
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(g, w)
    for factor in (2.0, 0.5):
        np.testing.assert_array_equal(port_transforms.resize_hwc(gt, factor),
                                      jax_transforms.resize_hwc(gt, factor))
    chw = port_transforms.hwc2chw(lq)
    np.testing.assert_array_equal(chw, jax_transforms.hwc2chw(lq))
    np.testing.assert_array_equal(port_transforms.chw2hwc(chw), jax_transforms.chw2hwc(chw))

    dn = (rng.rand(8, 9, 3) * 20000).astype(np.float32)
    for norm in ('LandsatNorm', 'SentinelNorm'):
        for max_sr in (0.3, 0.5):
            port = getattr(port_transforms, norm)(3, max_sr)
            jax_norm = getattr(jax_transforms, norm)(3, max_sr)
            np.testing.assert_array_equal(
                port(torch.from_numpy(chw2(dn))).numpy().transpose(1, 2, 0), jax_norm(dn))
    stats = {b: {'mean': 1000. + 100 * i, 'std': 500. + 10 * i}
             for i, b in enumerate(RGB_BANDS)}
    port = port_transforms.build_normalizer(stats, RGB_BANDS)
    want = jax_transforms.build_normalizer(stats, RGB_BANDS)(dn / 10)
    got = port(torch.from_numpy(chw2(dn / 10))).numpy().transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    assert want.min() == -1.0 and want.max() == 1.0   # both clamp
    with pytest.raises(ValueError, match='channels'):
        port(torch.zeros(2, 4, 4))


def chw2(hwc):
    return np.ascontiguousarray(hwc.transpose(2, 0, 1))


# ----------------------------------------------------------------- datasets
@pytest.mark.parametrize('phase', ['val', 'train'])
@pytest.mark.parametrize('kind', ['L2SSingleDataset', 'L2SSingleHMDataset',
                                  'L2SSingleMean2StdDataset'])
def test_items_match_jax(l2s_root, kind, phase):
    """Every item, twice over in the train phase (the second pass draws
    other crops and flips from the same generator), bit for bit."""
    opt = l2s_opt(l2s_root, kind, phase)
    port, jax_ds = port_build_dataset(opt), jax_build_dataset(opt)
    assert len(port) == len(jax_ds) == 4   # the window over psnr_max is filtered out
    passes = 2 if phase == 'train' else 1
    for _ in range(passes):
        for i in range(len(port)):
            got, want = port[i], jax_ds[i]
            assert got['lq']['rgb'].shape == (3, 12, 12)
            assert got['gt']['nss'].shape == (3, 18, 18)   # NSS at half the RGB grid
            assert_items_equal(got, want)


def test_hm_dataset_reads_the_matched_sentinel(l2s_root):
    plain = port_build_dataset(l2s_opt(l2s_root))[0]
    hm = port_build_dataset(l2s_opt(l2s_root, 'L2SSingleHMDataset'))[0]
    torch.testing.assert_close(plain['lq']['rgb'], hm['lq']['rgb'])
    assert not torch.equal(plain['gt']['rgb'], hm['gt']['rgb'])
    assert hm['gt']['rgb'].abs().max() <= 1.0 + 1e-6


@pytest.mark.parametrize('thresholds, count', [((20, 0.5, 50), 4), ((31, 0.5, 50), 2),
                                               ((20, 0.95, 50), 0), ((20, 0.5, 100), 5)])
def test_score_filter_matches_jax(l2s_root, thresholds, count):
    psnr_min, ssim_min, psnr_max = thresholds
    opt = l2s_opt(l2s_root, psnr_min=psnr_min, ssim_min=ssim_min, psnr_max=psnr_max)
    port, jax_ds = port_build_dataset(opt), jax_build_dataset(opt)
    assert port.sample_current_paths == jax_ds.sample_current_paths
    assert len(port) == count


@pytest.mark.parametrize('split_percent', [[0.8, 0.2], [0.5, 0.5], [0.999, 0.001], [3, 1]])
@pytest.mark.parametrize('kind', ['L2SSingleSplitDataset', 'L2SSingleHMSplitDataset',
                                  'L2SSingleMean2StdSplitDataset'])
def test_split_matches_jax(l2s_root, kind, split_percent):
    parts = []
    for split in (0, 1):
        opt = l2s_opt(l2s_root, kind, split_percent=split_percent, split=split)
        port, jax_ds = port_build_dataset(opt), jax_build_dataset(opt)
        np.testing.assert_array_equal(port.indices, jax_ds.indices)
        parts.append(list(port.indices))
        if len(port):
            assert_items_equal(port[0], jax_ds[0])
    assert sorted(parts[0] + parts[1]) == [0, 1, 2, 3]


def test_loader_collates_the_band_groups(l2s_root):
    opt = l2s_opt(l2s_root, phase='train', batch_size_per_gpu=2, num_worker_per_gpu=0)
    batch = next(iter(port_build_dataloader(port_build_dataset(opt), opt, num_gpu=0)))
    assert batch['lq']['rgb'].shape == (2, 3, 12, 12)
    assert batch['gt']['nss'].shape == (2, 3, 18, 18)
    assert len(batch['img_name']) == 2 and batch['img_name'][0].startswith('tile')


@pytest.mark.parametrize('kind', ['TacoDataset', 'TacoSplitDataset'])
def test_taco_raises_the_same_import_error(kind):
    opt = {'name': 'taco', 'type': kind, 'phase': 'train', 'scale': 4, 'band_idx': [1, 2, 3],
           'taco_paths': ['missing.taco'], 'gt_size': 64, 'split_percent': [0.9, 0.1],
           'split': 0}
    with pytest.raises(ImportError) as want:
        jax_build_dataset(opt)
    with pytest.raises(ImportError) as got:
        port_build_dataset(opt)
    assert str(got.value) == str(want.value)
    assert 'tacoreader' in str(got.value)
