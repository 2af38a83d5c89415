"""The port's folder-metric scripts (basicsr4rs_torch/scripts/metrics/:
calculate_psnr_ssim, calculate_niqe, calculate_lpips, back_projection)
against the JAX package's scripts of the same names on the same folders,
written by the test from crops of ``tests/data/baboon.png``: the numbers
each prints, or the images it writes. LPIPS runs on random weights written
in the layouts of torchvision's AlexNet file and the lpips heads' file."""

import contextlib
import importlib.util
import io
import re
from unittest import mock

import cv2
import numpy as np
import pytest

from basicsr4rs_torch.scripts.metrics import (back_projection, calculate_lpips, calculate_niqe,
                                              calculate_psnr_ssim)
from test_torch_lpips import write_weights

ROOT = __import__('pathlib').Path(__file__).resolve().parents[1]
BABOON = cv2.imread(str(ROOT / 'tests/data/baboon.png'))
NUMBER = re.compile(r'(-?\d+\.\d+)')


def jax_script(name):
    """The JAX package's ``scripts/metrics/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f'jax_{name}',
                                                  ROOT / 'scripts' / 'metrics' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(main, argv, program):
    """What ``main`` prints, run with ``argv`` as its command line."""
    out = io.StringIO()
    with mock.patch('sys.argv', [program] + argv), contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


def numbers(text):
    return [float(v) for v in NUMBER.findall(text)]


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    """GT: three crops of the baboon (one 200x200 for NIQE's 96-pixel
    blocks); restored: each with seeded Gaussian noise, saved as
    ``<name>_x4.png``; LQ: the GT at a quarter, bicubic."""
    root = tmp_path_factory.mktemp('metric_folders')
    rng = np.random.RandomState(0)
    for sub in ('gt', 'restored', 'lq'):
        (root / sub).mkdir()
    for name, (y, x, size) in {'a': (0, 0, 64), 'b': (100, 180, 48), 'c': (260, 280, 200)}.items():
        gt = BABOON[y:y + size, x:x + size]
        noisy = np.clip(gt + rng.randn(*gt.shape) * 8, 0, 255).round().astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{name}.png'), gt)
        cv2.imwrite(str(root / 'restored' / f'{name}_x4.png'), noisy)
        cv2.imwrite(str(root / 'lq' / f'{name}_x4.png'),
                    cv2.resize(gt, (size // 4, size // 4), interpolation=cv2.INTER_CUBIC))
    return root


@pytest.mark.parametrize('extra', [[], ['--test_y_channel', '--crop_border', '2']],
                         ids=['rgb_crop4', 'y_crop2'])
def test_psnr_ssim_prints_the_jax_numbers(folders, extra):
    """Every image's PSNR and SSIM and the averages, as printed to six
    decimals, to 1e-6 of the JAX script's (the same float64 host metric);
    a restored image that is missing is skipped in both."""
    (folders / 'gt' / 'd.png').write_bytes((folders / 'gt' / 'a.png').read_bytes())
    argv = ['--gt', str(folders / 'gt'), '--restored', str(folders / 'restored'),
            '--suffix', '_x4'] + extra
    try:
        want = printed(jax_script('calculate_psnr_ssim').main, argv, 'calculate_psnr_ssim.py')
        got = printed(lambda: calculate_psnr_ssim.main(argv), argv, 'calculate_psnr_ssim')
    finally:
        (folders / 'gt' / 'd.png').unlink()
    assert 'skip d' in got and 'skip d' in want
    assert len(numbers(got)) == len(numbers(want)) == 3 * 2 + 2
    np.testing.assert_allclose(numbers(got), numbers(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize('crop_border', [0, 4])
def test_niqe_prints_the_jax_numbers(folders, crop_border):
    """NIQE of the one image with 96-pixel blocks, to 1e-6 of the JAX
    script's printed score (the same float64 numpy computation)."""
    folder = folders / 'niqe'
    folder.mkdir(exist_ok=True)
    (folder / 'c.png').write_bytes((folders / 'gt' / 'c.png').read_bytes())
    argv = ['--input', str(folder), '--crop_border', str(crop_border)]
    want = printed(jax_script('calculate_niqe').main, argv, 'calculate_niqe.py')
    got = printed(lambda: calculate_niqe.main(argv), argv, 'calculate_niqe')
    assert len(numbers(got)) == len(numbers(want)) == 2
    np.testing.assert_allclose(numbers(got), numbers(want), atol=1e-6, rtol=0)


def test_lpips_prints_the_jax_numbers(folders, tmp_path):
    """LPIPS on random weights in the two torch files' layouts: each image's
    distance and the average within 1e-5 relative of the JAX script's
    (float32 AlexNet convolutions summed in another order; the printout has
    six decimals)."""
    paths = write_weights(tmp_path, 3)
    argv = ['--gt', str(folders / 'gt'), '--restored', str(folders / 'restored'),
            '--suffix', '_x4', '--alexnet_weights', paths['alexnet_path'],
            '--lin_weights', paths['lin_path']]
    want = printed(jax_script('calculate_lpips').main, argv, 'calculate_lpips.py')
    got = printed(lambda: calculate_lpips.main(argv + ['--device', 'cpu']), argv,
                  'calculate_lpips')
    assert len(numbers(got)) == len(numbers(want)) == 4
    assert min(numbers(got)) > 0
    np.testing.assert_allclose(numbers(got), numbers(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('mode', ['bp', 'if'])
def test_back_projection_writes_the_jax_images(folders, tmp_path, mode):
    """Three iterations of each refinement on the noisy outputs against their
    LQ: the port's PNGs equal the JAX script's, pixel for pixel (the same
    float64 MATLAB-style bicubic and 5x5 Gaussian), and differ from the
    inputs."""
    argv = ['--lr', str(folders / 'lq'), '--pre', str(folders / 'restored'), '--mode', mode,
            '--iters', '3']
    printed(jax_script('back_projection').main, argv + ['--out', str(tmp_path / 'jax')],
            'back_projection.py')
    names = back_projection.main(argv + ['--out', str(tmp_path / 'port')])
    assert names == ['a_x4.png', 'b_x4.png', 'c_x4.png']
    for name in names:
        got = cv2.imread(str(tmp_path / 'port' / name))
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / 'jax' / name)))
        assert not np.array_equal(got, cv2.imread(str(folders / 'restored' / name)))
