"""The port's FID (basicsr4rs_torch/archs/inception.py, metrics/fid.py and
the scripts under basicsr4rs_torch/scripts/metrics/) against the JAX
package's, on the CPU. One random torch ``state_dict`` with pytorch-fid's
key names (He-scaled convolutions, every BatchNorm statistic drawn from a
seeded numpy generator) feeds both packages, the JAX one through
``convert_torch_state_dict`` and ``InceptionV3.TORCH_KEY_RULES``.

Tolerances: each block's output within 1e-4 of its largest entry (float32
convolutions summed in another order); the statistics and the distance,
host float64 in both packages, within 1e-10 relative.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.inception import InceptionV3
from basicsr4rs_torch.metrics import fid as port_fid
from basicsr4rs_torch.scripts.metrics import (calculate_fid_folder,
                                              calculate_fid_stats_from_datasets,
                                              calculate_stylegan2_fid)
from basicsr4rs_tpu.archs.inception import InceptionV3 as JaxInceptionV3
from basicsr4rs_tpu.metrics import fid as jax_fid
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

BLOCK_TOL = 1e-4
CHANNELS = [64, 192, 768, 2048]

# scipy's sqrtm warns of the singular product below in both packages alike
SINGULAR_PRODUCTS = pytest.mark.filterwarnings('ignore::scipy.linalg.LinAlgWarning')


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def random_state_dict(seed=0):
    """pytorch-fid's keys, the classifier's among them, with He-scaled
    convolutions and BatchNorms near the identity, so that block 3 stays of
    order one."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in InceptionV3().state_dict().items():
        shape = tuple(value.shape)
        if key.endswith('num_batches_tracked'):
            sd[key] = value
            continue
        if key.endswith('conv.weight'):
            arr = rng.standard_normal(shape) * np.sqrt(2. / np.prod(shape[1:]))
        elif key.endswith(('bn.weight', 'running_var')):
            arr = rng.uniform(0.8, 1.2, shape)
        else:
            arr = rng.uniform(-0.1, 0.1, shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    sd['fc.weight'] = torch.from_numpy(rng.standard_normal((1008, 2048)).astype(np.float32))
    sd['fc.bias'] = torch.zeros(1008)
    return sd


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """(state_dict, JAX params, path of the .pth as pytorch-fid ships it: a
    bare state_dict with its classifier)."""
    sd = random_state_dict()
    path = str(tmp_path_factory.mktemp('inception') / 'pt_inception-random.pth')
    torch.save(sd, path)
    params = convert_torch_state_dict(
        {k: v for k, v in sd.items() if not k.startswith('fc.')}, JaxInceptionV3.TORCH_KEY_RULES)
    return sd, params, path


def port_net(sd, **kwargs):
    net = InceptionV3(**kwargs)
    net.load_state_dict({k: v for k, v in sd.items() if not k.startswith('fc.')}, strict=True)
    return net.eval()


def assert_block_close(got, want, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert scale > 1e-2, f'{what}: the block vanished ({scale})'
    assert err <= BLOCK_TOL * scale, f'{what}: {err} > {BLOCK_TOL} x {scale}'


def test_blocks_match_jax_without_resize(weights):
    """Two 75x75 images, ``resize_input`` off: all four blocks (64, 192,
    768, 2048 channels; block 3 pooled to 1x1), NCHW against NHWC."""
    sd, params, _ = weights
    x = np.random.default_rng(1).random((2, 3, 75, 75), dtype=np.float32)
    with torch.no_grad():
        got = port_net(sd, output_blocks=(0, 1, 2, 3), resize_input=False)(torch.from_numpy(x))
    want = JaxInceptionV3(output_blocks=(0, 1, 2, 3), resize_input=False).apply(
        {'params': params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert [o.shape[1] for o in got] == CHANNELS
    assert tuple(got[3].shape) == (2, 2048, 1, 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_block_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), f'block {i}')


def test_block3_matches_jax_with_resize(weights):
    """One 40x52 image resized to 299x299 (bilinear, no antialias) and
    normalised to [-1, 1] on both sides."""
    sd, params, _ = weights
    x = np.random.default_rng(2).random((1, 3, 40, 52), dtype=np.float32)
    with torch.no_grad():
        got = port_net(sd)(torch.from_numpy(x))[0].numpy()
    want = jax.jit(lambda p, v: JaxInceptionV3().apply({'params': p}, v)[0])(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert_block_close(got, np.asarray(want).transpose(0, 3, 1, 2), 'block 3, resized')


def test_output_blocks_are_checked():
    with pytest.raises(ValueError):
        InceptionV3(output_blocks=(4,))


def test_load_patched_inception_v3_raises_without_weights(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_fid.load_patched_inception_v3(str(tmp_path / 'absent.pth'), device='cpu')


def test_loaded_network_extracts_the_jax_features(weights):
    """``load_patched_inception_v3`` reads pytorch-fid's file as it is (its
    classifier left out) and ``extract_inception_features`` gives the JAX
    package's features over a generator of two batches."""
    sd, params, path = weights
    net = port_fid.load_patched_inception_v3(path, resize_input=False, device='cpu')
    assert net.output_blocks == (3,) and not net.training
    assert not net.normalize_input   # the FID network takes [-1, 1]
    rng = np.random.default_rng(3)
    batches = [rng.uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32) for _ in range(2)]
    got = port_fid.extract_inception_features(iter(batches), net)
    jnet, jparams = jax_fid.load_patched_inception_v3(path, resize_input=False)
    want = jax_fid.extract_inception_features(
        (b.transpose(0, 2, 3, 1) for b in batches), jnet, jparams)
    assert got.shape == (4, 2048) and got.dtype == np.float32
    assert_block_close(got, want, 'extracted features')


@SINGULAR_PRODUCTS
@pytest.mark.parametrize('singular', [False, True], ids=['finite-product', 'singular-product'])
def test_stats_and_fid_match_jax(singular, capsys):
    """The statistics of two sets of 64 x 16 features, and their FID. In the
    singular case the first covariance's leading 2 x 2 block is made
    nilpotent: the square root of the product is then not finite, and both
    packages retry with 1e-6 added to the diagonals. (scipy's ``sqrtm``
    returns a finite root for a singular product of two covariances, which
    is always diagonalisable; a defective one is what reaches the retry.)"""
    rng = np.random.default_rng(5)
    f1 = rng.standard_normal((64, 16))
    f2 = 0.5 + 1.3 * rng.standard_normal((64, 16))
    port_stats = port_fid.calculate_stats(f1), port_fid.calculate_stats(f2)
    jax_stats = jax_fid.calculate_stats(f1), jax_fid.calculate_stats(f2)
    for (pm, ps), (jm, js) in zip(port_stats, jax_stats):
        np.testing.assert_allclose(pm, jm, rtol=1e-10, atol=0)
        np.testing.assert_allclose(ps, js, rtol=1e-10, atol=0)
    (mu1, sigma1), (mu2, sigma2) = port_stats
    if singular:
        sigma1, sigma2 = np.eye(16), np.eye(16)
        sigma1[:2, :2] = [[0., 1.], [0., 0.]]
    got = port_fid.calculate_fid(mu1, sigma1, mu2, sigma2)
    retried = 'singular' in capsys.readouterr().out
    want = jax_fid.calculate_fid(mu1, sigma1, mu2, sigma2)
    assert retried == ('singular' in capsys.readouterr().out) == singular
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_fid_checks_its_shapes():
    mu, sigma = np.zeros(3), np.eye(3)
    with pytest.raises(ValueError):
        port_fid.calculate_fid(mu, sigma, np.zeros(4), sigma)
    with pytest.raises(ValueError):
        port_fid.calculate_fid(mu, sigma, mu, np.eye(4))


def test_folder_scripts_match_jax(weights, tmp_path):
    """``calculate_fid_stats_from_datasets`` writes the JAX functions'
    statistics of a folder (images resized to 80x80 by ``--size``, in two
    batches); ``calculate_fid_folder`` (at 299x299) scores the folder against
    other statistics as the port's functions do on its batches."""
    _, _, path = weights
    rng = np.random.default_rng(4)
    folder = tmp_path / 'imgs'
    (folder / 'sub').mkdir(parents=True)
    for i in range(3):
        img = (rng.random((30 + 4 * i, 36, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(folder / ('sub' if i else '') / f'{i}.png'), img)
    stats = str(tmp_path / 'stats.npz')
    calculate_fid_stats_from_datasets.main(['--folder', str(folder), '--output', stats,
                                            '--inception_weights', path, '--batch_size', '2',
                                            '--size', '80', '--device', 'cpu'])
    jnet, jparams = jax_fid.load_patched_inception_v3(path)
    batches = list(calculate_fid_folder.folder_batches(str(folder), 2, 80))
    assert [b.shape for b in batches] == [(2, 3, 80, 80), (1, 3, 80, 80)]
    feats = jax_fid.extract_inception_features([b.transpose(0, 2, 3, 1) for b in batches],
                                               jnet, jparams)
    mu, sigma = jax_fid.calculate_stats(feats)
    saved = np.load(stats)
    np.testing.assert_allclose(saved['mean'], mu, atol=BLOCK_TOL * np.abs(mu).max())
    np.testing.assert_allclose(saved['cov'], sigma, atol=2 * BLOCK_TOL * np.abs(sigma).max())

    other = str(tmp_path / 'other.npz')
    np.savez(other, mean=mu + 0.1, cov=sigma * 1.5)
    scored = score_of(calculate_fid_folder, ['--folder', str(folder), '--fid_stats', other,
                                             '--inception_weights', path, '--batch_size', '2',
                                             '--device', 'cpu'])
    net = port_fid.load_patched_inception_v3(path, device='cpu')
    feats = port_fid.extract_inception_features(
        calculate_fid_folder.folder_batches(str(folder), 3), net)
    assert_scored(scored, port_fid.calculate_stats(feats), (mu + 0.1, sigma * 1.5))


def score_of(script, argv):
    """The four arguments ``script.main(argv)`` hands ``calculate_fid``
    (the distance itself, a square root of 2048 x 2048 matrices, is held
    against JAX above on small ones)."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(script, 'calculate_fid', lambda *args: calls.append(args) or 0.)
        script.main(argv)
    assert len(calls) == 1
    return calls[0]


def assert_scored(scored, stats, reference):
    (mu, sigma), (ref_mu, ref_sigma) = stats, reference
    np.testing.assert_allclose(scored[0], mu, atol=BLOCK_TOL * np.abs(mu).max())
    np.testing.assert_allclose(scored[1], sigma, atol=2 * BLOCK_TOL * np.abs(sigma).max())
    np.testing.assert_array_equal(scored[2], ref_mu)
    np.testing.assert_array_equal(scored[3], ref_sigma)


def test_stylegan2_fid_script_samples_on_the_device_given(tmp_path, weights):
    """``calculate_stylegan2_fid`` at ``--out_size 8`` (a random generator
    saved as ``params_ema``), 5 samples in batches of 2: the statistics of
    the first 5 samples of its own stream go to ``calculate_fid`` with the
    given ones."""
    from basicsr4rs_torch.archs.stylegan2_arch import StyleGAN2Generator
    _, _, path = weights
    torch.manual_seed(0)
    net = StyleGAN2Generator(out_size=8, channel_multiplier=2).eval()
    ckpt = str(tmp_path / 'g.pth')
    torch.save({'params_ema': net.state_dict()}, ckpt)
    generator = torch.Generator().manual_seed(3)
    samples = torch.cat(list(calculate_stylegan2_fid.sample_batches(net, 5, 2, generator)))
    assert samples.shape == (6, 3, 8, 8) and 0 <= samples.min() and samples.max() <= 1
    inception = port_fid.load_patched_inception_v3(path, device='cpu')
    stats = port_fid.calculate_stats(port_fid.extract_inception_features([samples[:5]],
                                                                         inception))
    given = str(tmp_path / 'stats.npz')
    np.savez(given, mean=np.zeros(2048), cov=np.eye(2048))
    scored = score_of(calculate_stylegan2_fid, [
        '--ckpt', ckpt, '--fid_stats', given, '--out_size', '8', '--num_sample', '5',
        '--batch_size', '2', '--inception_weights', path, '--seed', '3', '--device', 'cpu'])
    assert_scored(scored, stats, (np.zeros(2048), np.eye(2048)))
