"""The port's Real-ESRGAN degradation engine against the JAX package's, on
the CPU: the host kernel synthesis (basicsr4rs_torch/data/degradations.py),
``filter2D``, the separable filter and USM (utils/img_process_util.py),
``DiffJPEG`` (utils/diffjpeg.py), the resize, the whole two-stage degrader
and the pair pool (ops/degradation_pipeline.py), and the port's own noise
samplers by their distributions.

Tolerances:
* kernel synthesis: bit for bit (both are float64 numpy on one RandomState);
* filters, USM, resize: 2e-6 absolute on [0, 1] images (float32 sums in
  another order);
* DiffJPEG: 1e-4 absolute in the differentiable mode; with
  ``round``, a coefficient a hair from .5 may round the other way and move
  its block, so at most 1e-3 of the pixels may be more than one 8-bit
  level apart;
* the degrader, every draw (the noise fields too) re-derived from the JAX
  key's splits: at most 1e-3 of the LQ pixels more than one 8-bit level
  apart, ``gt_usm`` within 2e-6;
* the Poisson sampler on the JAX sampler's uniform and normal fields:
  counts equal but for at most 1e-4 of them (exp and the sums in float32
  may put a uniform on the other side of a CDF step);
* the pool: equal.
"""

import math
from os import path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.data import degradations as port_deg
from basicsr4rs_torch.ops import degradation_pipeline as port_dp
from basicsr4rs_torch.utils import diffjpeg as port_jpeg
from basicsr4rs_torch.utils import img_process_util as port_ipu
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.data import degradations as jax_deg
from basicsr4rs_tpu.ops import degradation_pipeline as jax_dp
from basicsr4rs_tpu.utils import diffjpeg as jax_jpeg
from basicsr4rs_tpu.utils import img_process_util as jax_ipu

OPT = yaml_load(osp.join(osp.dirname(__file__), '..', 'options', 'train', 'RealESRGAN',
                         'train_realesrnet_x4plus.yml'))
N, C, ORI = 2, 3, 64
LEVEL = 1 / 255.
FILTER_TOL = 2e-6


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))


def share_past_one_level(got, want):
    return float(np.mean(np.abs(np.asarray(got) - np.asarray(want)) > LEVEL * 1.01))


def smooth_batch(seed, n=N, size=ORI):
    """Images with structure at several scales (a gradient, blobs, noise)."""
    rs = np.random.RandomState(seed)
    ramp = np.linspace(0, 0.6, size, dtype=np.float32)
    img = 0.3 * rs.rand(n, size, size, C).astype(np.float32) + ramp[None, :, None, None]
    img[:, size // 4:size // 2, size // 3:size // 2] += 0.3
    return np.clip(img, 0, 1).astype(np.float32)


# ------------------------------------------------------------ kernel synthesis
@pytest.mark.parametrize('fn,args', [
    ('bivariate_Gaussian', (21, 2.0, 3.0, 0.6)),
    ('bivariate_Gaussian', (13, 0.8, 0.8, 0.0)),
    ('bivariate_generalized_Gaussian', (21, 2.0, 3.0, 0.6, 1.5)),
    ('bivariate_generalized_Gaussian', (21, 2.0, 3.0, -0.4, 0.7)),
    ('bivariate_plateau', (21, 2.0, 3.0, 0.6, 1.5)),
    ('circular_lowpass_kernel', (np.pi / 3, 21)),
    ('circular_lowpass_kernel', (np.pi / 2, 13, 21)),
])
def test_kernel_synthesis_is_bit_for_bit(fn, args):
    np.testing.assert_array_equal(getattr(port_deg, fn)(*args), getattr(jax_deg, fn)(*args))


@pytest.mark.parametrize('kernel_type', ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
                                         'plateau_iso', 'plateau_aniso'])
def test_random_kernels_from_one_seed_are_bit_for_bit(kernel_type):
    """``random_mixed_kernels`` of each type, with multiplicative noise,
    five in a row from ``RandomState(7)``, and the state left behind."""
    draws = {}
    for name, mod in (('port', port_deg), ('jax', jax_deg)):
        rng = np.random.RandomState(7)
        draws[name] = [mod.random_mixed_kernels([kernel_type], [1.], 21, [0.2, 3], [0.2, 3],
                                                [-math.pi, math.pi], [0.5, 4], [1, 2],
                                                noise_range=[0.75, 1.25], rng=rng)
                       for _ in range(5)] + [rng.uniform()]
    for got, want in zip(draws['port'], draws['jax']):
        np.testing.assert_array_equal(got, want)


def test_random_jpg_compression_matches_jax():
    img = smooth_batch(1, n=1)[0]
    got = port_deg.random_add_jpg_compression(img, (30, 95), np.random.RandomState(3))
    want = jax_deg.random_add_jpg_compression(img, (30, 95), np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- filters and USM
def test_filter2d_per_sample_and_shared_kernels_match_jax():
    img = smooth_batch(2)
    rs = np.random.RandomState(4)
    kernels = np.stack([jax_deg.random_mixed_kernels(['aniso'], [1.], 21, [0.5, 3], [0.5, 3],
                                                     [-math.pi, math.pi], rng=rs)
                        for _ in range(N)]).astype(np.float32)
    for kernel in (kernels, kernels[0]):
        got = port_ipu.filter2D(nchw(img), torch.from_numpy(kernel))
        want = jax.jit(jax_ipu.filter2D)(jnp.asarray(img), jnp.asarray(kernel))
        np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=FILTER_TOL)


def test_separable_filter_and_usm_match_jax():
    img = smooth_batch(5)
    k1d = np.array(jax_ipu.USMSharp(radius=21).k1d)
    np.testing.assert_allclose(
        nhwc(port_ipu.sep_filter2d(nchw(img), torch.from_numpy(k1d))),
        jax.jit(jax_ipu.sep_filter2d)(jnp.asarray(img), jnp.asarray(k1d)), rtol=0,
        atol=FILTER_TOL)
    want = jax.jit(jax_ipu.USMSharp())(jnp.asarray(img))
    np.testing.assert_allclose(nhwc(port_ipu.USMSharp()(nchw(img))), want, rtol=0,
                               atol=FILTER_TOL)
    np.testing.assert_allclose(nhwc(port_ipu.usm_sharp(nchw(img), 0.4, 31, 5)),
                               jax.jit(jax_ipu.usm_sharp, static_argnums=(1, 2, 3))(
                                   jnp.asarray(img), 0.4, 31, 5), rtol=0,
                               atol=FILTER_TOL)


# ----------------------------------------------------------------- DiffJPEG
@pytest.mark.parametrize('differentiable', [True, False])
def test_diffjpeg_matches_jax(differentiable):
    """Per-sample qualities on both sides of 50, a size that is not a
    multiple of 16 (padding and the crop back)."""
    img = smooth_batch(6, size=ORI)[:, :52, :44]
    quality = np.array([23.5, 81.], np.float32)
    got = port_jpeg.DiffJPEG(differentiable)(nchw(img), torch.from_numpy(quality))
    want = np.asarray(jax.jit(jax_jpeg.DiffJPEG(differentiable))(jnp.asarray(img),
                                                              jnp.asarray(quality)))
    assert got.shape == (N, C, 52, 44)
    if differentiable:
        np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4)
    else:
        assert share_past_one_level(nhwc(got), want) <= 1e-3
    assert float(np.abs(nhwc(got) - img).mean()) > 1e-3   # it compressed


def test_quality_factor_and_diff_round_match_jax():
    q = np.array([1., 30., 49.9, 50., 95., 100.], np.float32)
    np.testing.assert_allclose(port_jpeg.quality_to_factor(torch.from_numpy(q)).numpy(),
                               jax_jpeg.quality_to_factor(jnp.asarray(q)), rtol=1e-7)
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_allclose(port_jpeg.diff_round(torch.from_numpy(x)).numpy(),
                               jax_jpeg.diff_round(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- resize
@pytest.mark.parametrize('method', [0, 1, 2], ids=port_dp.RESIZE_METHODS)
@pytest.mark.parametrize('sizes', [(64, 96, 64, 80), (96, 20, 77, 13), (20, 16, 13, 16)],
                         ids=['up onto a canvas', 'down from a canvas', 'canvas to the LQ'])
def test_resize_matches_scale_and_translate(method, sizes):
    """(input size, output size, valid input, valid output): the input is
    zero past its valid square, as on the canvases."""
    size_in, size_out, valid_in, valid_out = sizes
    img = smooth_batch(8, size=size_in)
    img[:, valid_in:] = 0
    img[:, :, valid_in:] = 0
    scale = jnp.full((2,), np.float32(valid_out) / np.float32(valid_in))
    name, antialias = [('linear', True), ('linear', False), ('cubic', False)][method]
    want = np.array(jax.jit(lambda x, s: jax.image.scale_and_translate(
        x, (N, size_out, size_out, C), (1, 2), s, jnp.zeros(2), method=name,
        antialias=antialias))(jnp.asarray(img), scale))
    want[:, valid_out:] = 0
    want[:, :, valid_out:] = 0
    got = port_dp.resize(nchw(img), size_out, valid_in, valid_out, method)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=FILTER_TOL)


# ------------------------------------------------------------- the degrader
def _noise_draw(key, gaussian, span, gray_prob, size):
    """A stage's noise draws as ``random_add_*_noise_jax`` takes them from
    its key: level, gray flags, then the colour and the gray fields."""
    key_s, key_g, key_n = jax.random.split(key, 3)
    level = jax.random.uniform(key_s, (N,), jnp.float32, span[0], span[1])
    gray = (jax.random.uniform(key_g, (N,), jnp.float32) < gray_prob).astype(jnp.float32)
    key_color, key_gray = jax.random.split(key_n)
    if gaussian:
        fields = (nchw(jax.random.normal(key_color, (N, size, size, C), jnp.float32)),
                  nchw(jax.random.normal(key_gray, (N, size, size, 1), jnp.float32)))
    else:
        def uniform_and_normal(k, channels):
            ku, kz = jax.random.split(k)
            shape = (N, size, size, channels)
            return (nchw(jax.random.uniform(ku, shape, jnp.float32)),
                    nchw(jax.random.normal(kz, shape, jnp.float32)))
        fields = (uniform_and_normal(key_color, C), uniform_and_normal(key_gray, 1))
    return port_dp.NoiseDraw(gaussian, torch.from_numpy(np.array(level)),
                             torch.from_numpy(np.array(gray)), fields)


def jax_draws(key, o=OPT, ori=ORI):
    """Every draw the JAX degrader makes from ``key``, in its order
    (degradation_pipeline.py:81-171), as the port's ``SynthesisDraws``."""
    nk = iter(jax.random.split(key, 24)).__next__
    canvas1 = int(math.ceil(ori * o['resize_range'][1]))
    canvas2 = int(math.ceil(ori / o['scale'] * o['resize_range2'][1]))

    def resize_draw(prob, span):
        mode = int(jax.random.choice(nk(), 3, p=jnp.asarray(prob)))
        k = nk()
        scale = [lambda: jax.random.uniform(k, (), jnp.float32, 1., span[1]),
                 lambda: jax.random.uniform(k, (), jnp.float32, span[0], 1.),
                 lambda: jnp.float32(1.)][mode]()
        return port_dp.RESIZE_MODES[mode], np.float32(scale)

    def noise_draw(suffix, size):
        gaussian = bool(jax.random.uniform(nk(), ()) < o['gaussian_noise_prob' + suffix])
        k_gauss, k_poisson = nk(), nk()
        return _noise_draw(k_gauss if gaussian else k_poisson, gaussian,
                           o[('noise_range' if gaussian else 'poisson_scale_range') + suffix],
                           o['gray_noise_prob' + suffix], size)

    def qualities(span):
        return torch.from_numpy(np.array(jax.random.uniform(nk(), (N,), jnp.float32, *span)))

    resize1, scale1 = resize_draw(o['resize_prob'], o['resize_range'])
    method1 = int(jax.random.randint(nk(), (), 0, 3))
    noise1 = noise_draw('', canvas1)
    jpeg_q1 = qualities(o['jpeg_range'])
    blur2 = bool(jax.random.uniform(nk(), ()) < o['second_blur_prob'])
    resize2, scale2 = resize_draw(o['resize_prob2'], o['resize_range2'])
    method2 = int(jax.random.randint(nk(), (), 0, 3))
    noise2 = noise_draw('2', canvas2)
    method3 = int(jax.random.randint(nk(), (), 0, 3))
    jpeg_q2 = qualities(o['jpeg_range2'])
    resize_first = bool(jax.random.uniform(nk(), ()) < 0.5)
    return port_dp.SynthesisDraws(resize1, scale1, method1, noise1, jpeg_q1, blur2, resize2,
                                  scale2, method2, noise2, method3, jpeg_q2, resize_first)


def degrader_kernels():
    rs = np.random.RandomState(1)
    ds = OPT['datasets']['train']
    k1 = np.stack([np.pad(jax_deg.random_mixed_kernels(
        ds['kernel_list'], ds['kernel_prob'], 13, ds['blur_sigma'], ds['blur_sigma'],
        [-math.pi, math.pi], ds['betag_range'], ds['betap_range'], rng=rs), 4)
        for _ in range(N)])
    k2 = np.stack([jax_deg.random_mixed_kernels(
        ds['kernel_list2'], ds['kernel_prob2'], 21, ds['blur_sigma2'], ds['blur_sigma2'],
        [-math.pi, math.pi], ds['betag_range2'], ds['betap_range2'], rng=rs) for _ in range(N)])
    sinc = np.stack([jax_deg.circular_lowpass_kernel(np.pi / 2, 13, pad_to=21)] * N)
    return [k.astype(np.float32) for k in (k1, k2, sinc)]


# JAX keys whose draws take every batch-level branch between them (held below)
BRANCH_SEEDS = [0, 2, 3, 4, 10, 11]


@pytest.fixture(scope='module')
def degraded():
    """For each of ``BRANCH_SEEDS``: the port's draws and the JAX degrader's
    (lq, gt_usm), from one jitted JAX degrader, on one batch."""
    gt = smooth_batch(0)
    kernels = degrader_kernels()
    run = jax.jit(jax_dp.RealESRGANDegrader(OPT))
    out = {}
    for seed in BRANCH_SEEDS:
        key = jax.random.PRNGKey(seed)
        lq, _, gt_usm = run(key, jnp.asarray(gt), *map(jnp.asarray, kernels))
        out[seed] = (jax_draws(key), np.asarray(lq), np.asarray(gt_usm))
    return gt, kernels, out


def test_branch_seeds_cover_every_batch_level_branch(degraded):
    taken = {}
    for draws, _, _ in degraded[2].values():
        for name, value in draws.branches().items():
            taken.setdefault(name, set()).add(value)
    modes, methods = set(port_dp.RESIZE_MODES), set(port_dp.RESIZE_METHODS)
    assert taken == {'resize1': modes, 'method1': methods, 'noise1': {'gaussian', 'poisson'},
                     'blur2': {True, False}, 'resize2': modes, 'method2': methods,
                     'noise2': {'gaussian', 'poisson'}, 'method3': methods,
                     'order': {'resize+sinc, jpeg', 'jpeg, resize+sinc'}}


@pytest.mark.parametrize('seed', BRANCH_SEEDS)
def test_degrader_matches_jax_with_its_draws(seed, degraded):
    gt, kernels, out = degraded
    draws, want_lq, want_usm = out[seed]
    lq, gt_out, gt_usm = port_dp.RealESRGANDegrader(OPT).apply(
        nchw(gt), *map(torch.from_numpy, kernels), draws)
    assert lq.shape == (N, C, ORI // 4, ORI // 4)
    np.testing.assert_array_equal(nhwc(gt_out), gt)
    np.testing.assert_allclose(nhwc(gt_usm), want_usm, rtol=0, atol=FILTER_TOL)
    assert share_past_one_level(nhwc(lq), want_lq) <= 1e-3, draws.branches()
    assert float(lq.std()) > 0.01


def test_draws_are_host_choices_and_device_tensors_of_the_right_shapes():
    deg = port_dp.RealESRGANDegrader(OPT)
    draws = deg.draw((N, C, ORI, ORI), np.random.default_rng(0), torch.Generator().manual_seed(0))
    canvas1, canvas2 = deg.canvases(ORI)
    assert (canvas1, canvas2) == (96, 20)
    assert isinstance(draws.scale1, np.float32) and isinstance(draws.blur2, bool)
    for noise, size in ((draws.noise1, canvas1), (draws.noise2, canvas2)):
        fields = noise.fields if noise.gaussian else noise.fields[0] + noise.fields[1]
        assert {tuple(f.shape) for f in fields} <= {(N, C, size, size), (N, 1, size, size)}
        assert noise.level.shape == noise.gray.shape == (N,)
    lq, _, _ = deg.apply(nchw(smooth_batch(0)), *map(torch.from_numpy, degrader_kernels()), draws)
    assert lq.shape == (N, C, ORI // 4, ORI // 4) and 0 <= float(lq.min()) <= float(lq.max()) <= 1


# ------------------------------------------------------------ crop and pool
def test_crop_and_pool_match_jax_through_fill_and_swap():
    """Queue of 4 pairs, batches of 2: two fills, then three swaps with the
    JAX permutations; and the aligned crop at the JAX offsets."""
    lq_shape, gt_shape = (4, 4, C), (16, 16, C)
    jax_pool = jax_dp.TrainingPairPool(4, lq_shape, gt_shape)
    state = jax_pool.init_state()
    update = jax.jit(jax_pool.update)
    pool = port_dp.TrainingPairPool(4)
    rs = np.random.RandomState(9)
    for step in range(5):
        lq = rs.rand(2, *lq_shape).astype(np.float32)
        gt = rs.rand(2, *gt_shape).astype(np.float32)
        key = jax.random.PRNGKey(step)
        state, want_lq, want_gt = update(key, state, jnp.asarray(lq), jnp.asarray(gt))
        perm = torch.from_numpy(np.array(jax.random.permutation(key, 4)))
        got_lq, got_gt = pool.update(nchw(lq), nchw(gt), perm=perm)
        np.testing.assert_array_equal(nhwc(got_lq), want_lq)
        np.testing.assert_array_equal(nhwc(got_gt), want_gt)
    np.testing.assert_array_equal(nhwc(pool.lq), state['lq'])
    np.testing.assert_array_equal(nhwc(pool.gt), state['gt'])
    assert (pool.ptr, pool.swaps) == (4, 3)
    with pytest.raises(ValueError, match='divisible'):
        pool.update(nchw(lq[:1].repeat(3, 0)), nchw(gt[:1].repeat(3, 0)))

    gts = [rs.rand(2, 40, 40, C).astype(np.float32) for _ in range(2)]
    lq = rs.rand(2, 10, 10, C).astype(np.float32)
    key = jax.random.PRNGKey(5)
    (want_a, want_b), want_lq = jax_dp.paired_random_crop_traced(key, list(map(jnp.asarray, gts)),
                                                                 jnp.asarray(lq), 16, 4)
    kt, kl = jax.random.split(key)
    top, left = (int(jax.random.randint(k, (), 0, 10 - 4 + 1)) for k in (kt, kl))
    (got_a, got_b), got_lq = port_dp.paired_random_crop_traced(list(map(nchw, gts)), nchw(lq), 16,
                                                               4, top, left)
    for got, want in ((got_a, want_a), (got_b, want_b), (got_lq, want_lq)):
        np.testing.assert_array_equal(nhwc(got), want)


# --------------------------------------------------- the port's own samplers
def _port_poisson(lam_value, n=200_000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lam = torch.full((n,), float(lam_value))
    return port_deg.poisson_sample(lam, *port_deg.poisson_fields(lam.shape, gen)).numpy()


@pytest.mark.parametrize('lam', [0.3, 2.5, 8.0, 11.9])
def test_poisson_below_the_switch_matches_the_pmf(lam):
    """The inverse-CDF regime: each bin with mass above 1e-4 within 4
    binomial standard errors of the Poisson pmf."""
    from scipy import stats
    s = _port_poisson(lam)
    counts = np.bincount(s.astype(np.int64)) / s.size
    pmf = stats.poisson.pmf(np.arange(counts.size), lam)
    stderr = np.sqrt(pmf * (1 - pmf) / s.size)
    mask = pmf > 1e-4
    assert np.all(np.abs(counts[mask] - pmf[mask]) < 4 * stderr[mask] + 1e-4)


@pytest.mark.parametrize('lam', [12.0, 20.0, 64.0, 220.0])
def test_poisson_above_the_switch_has_the_moments(lam):
    s = _port_poisson(lam)
    assert abs(s.mean() - lam) < 5 * np.sqrt(lam / s.size)
    assert abs(s.var() / lam - 1.0) < 0.05
    assert np.all(s >= 0) and np.array_equal(s, np.round(s))


def test_poisson_of_zero_is_zero_and_matches_jax_on_its_fields():
    assert np.all(_port_poisson(0.0, n=1000) == 0)
    rs = np.random.RandomState(0)
    lam = rs.uniform(0, 40, (50_000,)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jax_deg._poisson_tpu)(key, jnp.asarray(lam)))
    ku, kz = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(ku, lam.shape, jnp.float32)))
    z = torch.from_numpy(np.array(jax.random.normal(kz, lam.shape, jnp.float32)))
    got = port_deg.poisson_sample(torch.from_numpy(lam), u, z).numpy()
    assert np.mean(got != want) <= 1e-4


def test_poisson_vals_count_levels_as_the_jax_package():
    rs = np.random.RandomState(1)
    img = np.round(rs.rand(3, 24, 24, C) * 255) / 255
    img[1] = np.round(img[1] * 4) / 4          # 5 levels -> 8
    img[2] = 0.5                               # 1 level -> 1
    img = img.astype(np.float32)
    got = port_deg.poisson_vals(nchw(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_deg._poisson_vals(jnp.asarray(img))))
    np.testing.assert_array_equal(got[1:], [8., 1.])


def test_poisson_noise_gray_is_the_same_on_every_channel():
    gen = torch.Generator().manual_seed(0)
    img = nchw(smooth_batch(3, size=16))
    ones = torch.ones(N)
    gray = port_deg.generate_poisson_noise(img, ones, ones, gen)
    colour = port_deg.generate_poisson_noise(img, ones, torch.zeros(N), gen)
    assert torch.equal(gray[:, 0], gray[:, 1]) and torch.equal(gray[:, 1], gray[:, 2])
    assert not torch.allclose(colour[:, 0], colour[:, 1])
    out = port_deg.random_add_poisson_noise(img, (1.0, 3.0), 0.5, clip=True, generator=gen)
    assert 0 <= float(out.min()) and float(out.max()) <= 1 and not torch.allclose(out, img)


def test_gaussian_noise_has_its_sigma_and_gray_is_shared():
    gen = torch.Generator().manual_seed(0)
    img = torch.full((4, C, 64, 64), 0.5)
    out = port_deg.random_add_gaussian_noise(img, (10, 10), 0., clip=False, generator=gen)
    assert abs(float((out - 0.5).std()) - 10 / 255.) < 1e-3
    gray = port_deg.generate_gaussian_noise(img, torch.full((4,), 10.), torch.ones(4), gen)
    assert torch.equal(gray[:, 0], gray[:, 2])
