"""The port's host metrics of the remote-sensing path
(basicsr4rs_torch/metrics/psnr_ssim.py's band variants, metrics/niqe.py,
utils/matlab_functions.py) against the JAX package's on the same numpy
inputs: multispectral uint8 images and crops of ``tests/data/baboon.png``.
Both run float64 numpy and scipy, so the tolerance is 1e-6 relative."""

import os

import cv2
import numpy as np
import pytest

from basicsr4rs_torch.metrics import calculate_metric as port_metric
from basicsr4rs_torch.metrics import niqe as port_niqe
from basicsr4rs_torch.utils import matlab_functions as port_matlab
from basicsr4rs_tpu.metrics import calculate_metric as jax_metric
from basicsr4rs_tpu.metrics import niqe as jax_niqe
from basicsr4rs_tpu.utils import matlab_functions as jax_matlab

BABOON = os.path.join(os.path.dirname(__file__), 'data', 'baboon.png')
RTOL = 1e-6


@pytest.fixture(scope='module')
def baboon():
    return cv2.imread(BABOON)


def multispectral(seed, h=40, w=44, bands=6):
    """Two 6-band uint8 images: a smooth one and a noisy copy of it."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 8 + 2, w // 8 + 2, bands).astype(np.float32)
    img = np.stack([cv2.resize(coarse[..., b], (w, h), interpolation=cv2.INTER_CUBIC)
                    for b in range(bands)], -1)
    img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
    noisy = np.clip(img + rng.randn(h, w, bands) * 6, 0, 255).round().astype(np.uint8)
    return img, noisy


@pytest.mark.parametrize('band', [0, 3, 5])
@pytest.mark.parametrize('metric', ['calculate_psnr_band', 'calculate_ssim_band'])
def test_band_metrics_match_jax(metric, band):
    img, img2 = multispectral(band)
    for crop_border, order in ((0, 'HWC'), (4, 'HWC'), (4, 'CHW')):
        a, b = (img, img2) if order == 'HWC' else (img.transpose(2, 0, 1), img2.transpose(2, 0, 1))
        opt = {'type': metric, 'crop_border': crop_border, 'band': band, 'input_order': order}
        got = port_metric({'img': a, 'img2': b}, opt)
        want = jax_metric({'img': a, 'img2': b}, opt)
        assert np.isfinite(got) and got == pytest.approx(float(want), rel=RTOL)
    # one band only: another band's error does not enter
    changed = img2.copy()
    changed[..., (band + 1) % 6] = 0
    opt = {'type': metric, 'crop_border': 0, 'band': band}
    assert port_metric({'img': img, 'img2': changed}, opt) == pytest.approx(
        port_metric({'img': img, 'img2': img2}, opt), rel=1e-12)


@pytest.mark.parametrize('scale, antialiasing', [(0.5, True), (0.5, False), (1 / 3, True),
                                                 (2.0, True), (0.75, True)])
def test_imresize_matches_jax(baboon, scale, antialiasing):
    img = baboon[:37, :50].astype(np.float64) / 255.
    got = port_matlab.imresize(img, scale, antialiasing)
    want = jax_matlab.imresize(img, scale, antialiasing)
    assert got.shape == want.shape == (int(np.ceil(37 * scale)), int(np.ceil(50 * scale)), 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(port_matlab.imresize_uint8(baboon[:37, :50], scale, antialiasing),
                                  jax_matlab.imresize_uint8(baboon[:37, :50], scale, antialiasing))
    gray = img[..., 0]
    np.testing.assert_allclose(port_matlab.imresize(gray, scale, antialiasing),
                               jax_matlab.imresize(gray, scale, antialiasing), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize('length, out, scale', [(10, 5, 0.5), (7, 21, 3.0), (9, 3, 1 / 3)])
def test_resize_weights_match_jax(length, out, scale):
    got = port_matlab.calculate_weights_indices(length, out, scale)
    want = jax_matlab.calculate_weights_indices(length, out, scale)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(port_matlab.cubic(x), jax_matlab.cubic(x))


def test_niqe_matches_jax_and_matlab_on_baboon(baboon):
    got = port_metric({'img': baboon}, {'type': 'calculate_niqe', 'crop_border': 0})
    want = jax_metric({'img': baboon}, {'type': 'calculate_niqe', 'crop_border': 0})
    assert got == pytest.approx(want, rel=RTOL)
    assert got == pytest.approx(5.7296, abs=1e-4)   # MATLAB R2021a's value


CROP = (slice(40, 40 + 224), slice(100, 100 + 200))   # 2x2 blocks of 96 after a border of 4


@pytest.mark.parametrize('opt', [
    {'type': 'calculate_niqe', 'crop_border': 4},
    {'type': 'calculate_niqe', 'crop_border': 4, 'convert_to': 'gray'},
    {'type': 'calculate_rs_niqe', 'crop_border': 4},
    {'type': 'calculate_rs_niqe', 'crop_border': 4, 'input_bands': [3, 4, 5]},
    {'type': 'calculate_niqe_band', 'crop_border': 4, 'band': 0},
    {'type': 'calculate_niqe_band', 'crop_border': 4, 'band': 4},
], ids=['y', 'gray', 'rs-rgb', 'rs-nss', 'band0', 'band4'])
def test_niqe_variants_match_jax_on_a_baboon_crop(baboon, opt):
    """On a crop of 224x200, and for the band variants on a 6-band stack of
    the crop and its mirror image."""
    crop = np.ascontiguousarray(baboon[CROP])
    img = np.concatenate([crop, crop[:, ::-1]], -1) if opt['type'] != 'calculate_niqe' else crop
    got = port_metric({'img': img}, opt)
    want = jax_metric({'img': img}, opt)
    assert np.isfinite(got) and got == pytest.approx(float(want), rel=RTOL)


def test_niqe_reads_the_ports_own_parameters():
    assert os.path.dirname(port_niqe.PARAMS_PATH) == os.path.dirname(port_niqe.__file__)
    for got, want in zip(port_niqe.load_niqe_params(), jax_niqe.load_niqe_params()):
        np.testing.assert_array_equal(got, want)
    assert port_metric({}, {'type': 'calculate_niqe_none'}) == -1
