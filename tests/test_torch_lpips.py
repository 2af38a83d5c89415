"""The port's LPIPS (basicsr4rs_torch/metrics/lpips.py) against the JAX
package's, on random AlexNet and linear-head weights written to ``.pth``
files in the torch key layout (torchvision's ``features.<i>``, the lpips
package's ``lin<i>.model.1.weight``): distances within 1e-5 of each other,
the ``FileNotFoundError`` without weights, ``calculate_lpips_none``, and a
cache that never hands one file pair's network to another. Float32 on the
CPU. The JAX package keeps the first weights it loads for the whole process
(``_EVALUATOR``): each comparison clears it first."""

import numpy as np
import pytest
import torch

from basicsr4rs_torch.metrics import calculate_metric
from basicsr4rs_torch.metrics import lpips as port_lpips
from basicsr4rs_tpu.metrics import lpips as jax_lpips

ALEX = ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3), (10, 256, 256, 3))
TOL = 1e-5


def write_weights(folder, seed):
    """Random AlexNet features (std 1/sqrt(fan-in)) and non-negative linear
    heads, as the two published files hold them; the paths."""
    gen = torch.Generator().manual_seed(seed)
    alex = {}
    for i, cin, cout, k in ALEX:
        alex[f'features.{i}.weight'] = torch.randn(cout, cin, k, k, generator=gen) * (
            cin * k * k)**-0.5
        alex[f'features.{i}.bias'] = torch.randn(cout, generator=gen) * 0.05
    alex['classifier.1.weight'] = torch.randn(8, 9216, generator=gen)   # unused by LPIPS
    lins = {f'lin{i}.model.1.weight': torch.rand(1, cout, 1, 1, generator=gen)
            for i, (_, _, cout, _) in enumerate(ALEX)}
    paths = {'alexnet_path': str(folder / f'alexnet-{seed}.pth'),
             'lin_path': str(folder / f'lin-{seed}.pth')}
    torch.save(alex, paths['alexnet_path'])
    torch.save(lins, paths['lin_path'])
    return paths


@pytest.fixture
def weights(tmp_path):
    jax_lpips._EVALUATOR.clear()
    yield write_weights(tmp_path, 0)
    jax_lpips._EVALUATOR.clear()


def images(seed, h=72, w=68, c=6):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (h, w, c)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 40, a.shape), 0, 255)
    return a.round().astype(np.uint8), b.round().astype(np.uint8)


@pytest.mark.parametrize('band,crop_border', [(0, 4), (3, 0), (5, 2)])
def test_lpips_band_matches_jax(weights, band, crop_border):
    img, img2 = images(band)
    got = port_lpips.calculate_lpips_band(img, img2, crop_border, band, **weights)
    want = jax_lpips.calculate_lpips_band(img, img2, crop_border, band, **weights)
    assert got > 0 and got == pytest.approx(want, rel=TOL)
    chw = port_lpips.calculate_lpips_band(img.transpose(2, 0, 1), img2.transpose(2, 0, 1),
                                          crop_border, band, input_order='CHW', **weights)
    assert chw == pytest.approx(got, rel=1e-6)


def test_lpips_network_matches_jax(weights):
    """The distances of a batch, and the metric through ``calculate_metric``
    with the weight files given in its options as a config gives them."""
    import jax.numpy as jnp
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    net = port_lpips.load_lpips_weights(port_lpips.LPIPS(), weights['alexnet_path'],
                                        weights['lin_path'])
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                  torch.from_numpy(y.transpose(0, 3, 1, 2).copy())).numpy()
    params = jax_lpips.load_lpips_weights(weights['alexnet_path'], weights['lin_path'])
    want = np.asarray(jax_lpips.LPIPS().apply({'params': params}, jnp.asarray(x),
                                              jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=TOL)
    img, img2 = images(8)
    opt = dict(type='calculate_lpips_band', band=1, crop_border=4, **weights)
    assert calculate_metric({'img': img, 'img2': img2}, opt) == pytest.approx(
        jax_lpips.calculate_lpips_band(img, img2, 4, 1, **weights), rel=TOL)


def test_lpips_cache_is_per_weight_files(tmp_path, weights):
    """Another file pair gives another distance: the network made for the
    first pair is not handed to the second."""
    other = write_weights(tmp_path, 1)
    img, img2 = images(9)
    first = port_lpips.calculate_lpips_band(img, img2, 0, 2, **weights)
    second = port_lpips.calculate_lpips_band(img, img2, 0, 2, **other)
    assert first != pytest.approx(second, rel=1e-3)
    assert port_lpips.calculate_lpips_band(img, img2, 0, 2, **weights) == first


def test_lpips_without_weights_raises_in_both_packages(tmp_path):
    img, img2 = images(10)
    missing = {'alexnet_path': str(tmp_path / 'absent-alexnet.pth'),
               'lin_path': str(tmp_path / 'absent-lin.pth')}
    jax_lpips._EVALUATOR.clear()
    for metric in (port_lpips.calculate_lpips_band, jax_lpips.calculate_lpips_band):
        with pytest.raises(FileNotFoundError, match='LPIPS weight file missing'):
            metric(img, img2, 4, 0, **missing)
    with pytest.raises(FileNotFoundError, match='alexnet-owt.pth'):
        port_lpips.calculate_lpips_band(img, img2, 4, 0)   # the default files are absent
    jax_lpips._EVALUATOR.clear()


def test_lpips_none_answers_minus_one():
    img, img2 = images(11)
    assert port_lpips.calculate_lpips_none(img=img, img2=img2, crop_border=4) == -1
    assert calculate_metric({'img': img, 'img2': img2}, {'type': 'calculate_lpips_none'}) == -1
