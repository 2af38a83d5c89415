"""The port's diffusion engine (basicsr4rs_torch/utils/gaussian_diffusion.py)
against the JAX package's: the schedule and every table derived from it
exactly (both float64 numpy), the forward and reverse processes and the
training losses on the same numpy inputs with the timesteps and the noise
handed in, and a whole reverse chain replaying the JAX chain's draws.
Float32 on the CPU, 1e-4 of the largest entry (the tables are cast to
float32 per use on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.utils import gaussian_diffusion as port
from basicsr4rs_tpu.utils import gaussian_diffusion as ref

from test_torch_unet import assert_close_rel, nchw, nhwc

PREDICT_TYPES = ['xstart', 'epsilon', 'epsilon_scale', 'residual']
TABLES = ('sqrt_etas', 'etas', 'etas_prev', 'alpha', 'posterior_variance',
          'posterior_variance_clipped', 'posterior_log_variance_clipped',
          'posterior_mean_coef1', 'posterior_mean_coef2', 'weight_loss_mse')


def _both(predict_type='xstart', steps=4, weighted_mse=False, **kw):
    cfg = dict(normalize_input=True, schedule_name='exponential', sf=4, min_noise_level=0.2,
               steps=steps, kappa=2.0, etas_end=0.99, schedule_kwargs={'power': 0.3},
               predict_type=predict_type, timestep_respacing=None, scale_factor=1.0,
               latent_flag=True, weighted_mse=weighted_mse)
    cfg.update(kw)
    return ref.create_gaussian_diffusion(**cfg), port.create_gaussian_diffusion(**cfg)


@pytest.mark.parametrize('steps, kappa, power, min_noise', [
    (15, 2.0, 0.3, 0.04), (4, 1.0, 1.0, 0.2), (1000, 2.0, 0.3, 0.04)])
def test_eta_schedule_is_exact(steps, kappa, power, min_noise):
    want = ref.get_named_eta_schedule('exponential', steps, min_noise, kappa=kappa,
                                      kwargs={'power': power})
    got = port.get_named_eta_schedule('exponential', steps, min_noise, kappa=kappa,
                                      kwargs={'power': power})
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('predict_type', PREDICT_TYPES)
@pytest.mark.parametrize('respacing', [None, 5])
def test_every_derived_table_is_exact(predict_type, respacing):
    want, got = _both(predict_type, steps=15, min_noise_level=0.04,
                      timestep_respacing=respacing)
    assert got.num_timesteps == want.num_timesteps == (respacing or 15)
    assert got.timestep_map == want.timestep_map
    assert got.original_num_steps == want.original_num_steps == 15
    for name in TABLES:
        table = getattr(got, name)
        assert table.dtype == np.float64, name
        np.testing.assert_array_equal(table, getattr(want, name), err_msg=name)
    assert port.space_timesteps(15, 5) == ref.space_timesteps(15, 5)


def _data(seed=0, b=3, c=3, size=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, size, size).astype(np.float32),
            rng.randn(b, c, size, size).astype(np.float32),
            rng.randn(b, c, size, size).astype(np.float32), np.array([0, 2, 3][:b], np.int32))


def test_q_sample_and_posterior():
    want_d, got_d = _both()
    x0, y, noise, t = _data()
    tt = torch.from_numpy(t).long()
    want = want_d.q_sample(nhwc(x0), nhwc(y), jnp.asarray(t), nhwc(noise))
    got = got_d.q_sample(*(torch.from_numpy(a) for a in (x0, y)), tt, torch.from_numpy(noise))
    assert_close_rel(got.numpy(), nchw(want), 1e-4)
    for w_, g_ in zip(want_d.q_mean_variance(nhwc(x0), nhwc(y), jnp.asarray(t)),
                      got_d.q_mean_variance(torch.from_numpy(x0), torch.from_numpy(y), tt)):
        assert_close_rel(g_.numpy(), nchw(w_), 1e-4)
    for w_, g_ in zip(
            want_d.q_posterior_mean_variance(nhwc(x0), nhwc(y), jnp.asarray(t)),
            got_d.q_posterior_mean_variance(torch.from_numpy(x0), torch.from_numpy(y), tt)):
        assert_close_rel(g_.numpy(), nchw(w_), 1e-4)
    with pytest.raises(ValueError):
        got_d.q_sample(torch.from_numpy(x0), torch.from_numpy(y), tt, torch.zeros(1))


def _jax_model(x, t, **kw):
    return jnp.tanh(0.7 * x) + 0.1 * t.reshape(-1, 1, 1, 1)


def _torch_model(x, t, **kw):
    return torch.tanh(0.7 * x) + 0.1 * t.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize('predict_type', PREDICT_TYPES)
@pytest.mark.parametrize('latent_flag', [True, False])
def test_p_mean_variance(predict_type, latent_flag):
    want_d, got_d = _both(predict_type, latent_flag=latent_flag)
    x_t, y, _, t = _data(1)
    want = want_d.p_mean_variance(_jax_model, nhwc(x_t), nhwc(y), jnp.asarray(t))
    got = got_d.p_mean_variance(_torch_model, torch.from_numpy(x_t), torch.from_numpy(y),
                                torch.from_numpy(t).long())
    assert got.keys() == want.keys()
    for key in want:
        assert_close_rel(got[key].numpy(), nchw(want[key]), 1e-4, key)


class _HalvingStage:
    """A first stage both frameworks can run: encode halves, decode doubles."""

    def encode(self, x):
        return 0.5 * x

    def decode(self, z):
        return 2.0 * z


@pytest.mark.parametrize('predict_type', PREDICT_TYPES)
@pytest.mark.parametrize('weighted_mse', [False, True])
def test_training_losses_with_given_timesteps_and_noise(predict_type, weighted_mse):
    want_d, got_d = _both(predict_type, weighted_mse=weighted_mse, scale_factor=0.8)
    rng = np.random.RandomState(2)
    gt = rng.randn(3, 3, 8, 8).astype(np.float32)
    lq = rng.randn(3, 3, 2, 2).astype(np.float32)      # upsampled x4 by the engine
    noise = rng.randn(3, 3, 8, 8).astype(np.float32)
    t = np.array([0, 1, 3], np.int32)
    stage = _HalvingStage()
    want = want_d.training_losses(jax.random.PRNGKey(0), _jax_model, nhwc(gt), nhwc(lq),
                                  jnp.asarray(t), first_stage_model=stage, noise=nhwc(noise))
    got = got_d.training_losses(None, _torch_model, torch.from_numpy(gt), torch.from_numpy(lq),
                                torch.from_numpy(t).long(), first_stage_model=stage,
                                noise=torch.from_numpy(noise))
    assert list(got[0]) == list(want[0]) == ['mse']
    assert_close_rel(got[0]['mse'].numpy(), np.asarray(want[0]['mse']), 1e-4, 'mse')
    assert_close_rel(got[1].numpy(), nchw(want[1]), 1e-4, 'z_t')
    assert_close_rel(got[2].numpy(), nchw(want[2]), 1e-4, 'pred_zstart')


def test_training_losses_draws_its_noise_from_the_generator():
    _, got_d = _both()
    gt, lq = torch.zeros(2, 3, 8, 8), torch.zeros(2, 3, 2, 2)
    t = torch.tensor([1, 2])
    runs = [got_d.training_losses(torch.Generator().manual_seed(seed), _torch_model, gt, lq, t)[1]
            for seed in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def _jax_chain_noise(key, steps, shape):
    """The draws of the JAX ``p_sample_loop``: the prior's noise, then one
    per reverse step, in the order the scan takes them."""
    key, nkey = jax.random.split(key)
    first = jax.random.normal(nkey, shape, jnp.float32)
    keys = jax.random.split(key, steps)
    return first, [jax.random.normal(k, shape, jnp.float32) for k in keys]


@pytest.mark.parametrize('predict_type', PREDICT_TYPES)
def test_whole_sampling_chain_replays_the_jax_draws(predict_type):
    want_d, got_d = _both(predict_type, scale_factor=0.8)
    lq = np.random.RandomState(3).randn(2, 3, 2, 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    stage = _HalvingStage()
    want = want_d.p_sample_loop(key, nhwc(lq), _jax_model, first_stage_model=stage)
    first, steps = _jax_chain_noise(key, 4, (2, 8, 8, 3))
    got = got_d.p_sample_loop(None, torch.from_numpy(lq), _torch_model, first_stage_model=stage,
                              noise=torch.from_numpy(nchw(first)),
                              step_noise=[torch.from_numpy(nchw(n)) for n in steps])
    assert got.shape == (2, 3, 8, 8)
    assert_close_rel(got.numpy(), nchw(want), 1e-4)


def test_sampling_chain_from_a_generator_is_reproducible_and_without_gradients():
    _, got_d = _both()
    lq = torch.randn(1, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    scale = torch.ones((), requires_grad=True)
    outs = [got_d.p_sample_loop(torch.Generator().manual_seed(seed), lq,
                                lambda x, t: scale * _torch_model(x, t)) for seed in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not outs[0].requires_grad and torch.isfinite(outs[0]).all()
    repeated = got_d.p_sample_loop(torch.Generator().manual_seed(3), lq.repeat(2, 1, 1, 1),
                                   _torch_model, noise_repeat=True)
    assert torch.allclose(repeated[0], repeated[1])


def test_first_stage_coding_splits_three_channels_at_a_time():
    """Six bands go through the first stage as two chunks of three; four
    bands are refused on both sides (``split_channels`` is 3 everywhere)."""
    want_d, got_d = _both(scale_factor=0.8)
    stage = _HalvingStage()
    y = np.random.RandomState(4).randn(1, 6, 2, 2).astype(np.float32)
    want = want_d.encode_first_stage(nhwc(y), stage, up_sample=True)
    got = got_d.encode_first_stage(torch.from_numpy(y), stage, up_sample=True)
    assert_close_rel(got.numpy(), nchw(want), 1e-4)
    assert_close_rel(got_d.decode_first_stage(got, stage).numpy(),
                     nchw(want_d.decode_first_stage(want, stage)), 1e-4)
    four = np.zeros((1, 4, 2, 2), np.float32)
    with pytest.raises(AssertionError):
        want_d.encode_first_stage(nhwc(four), stage)
    with pytest.raises(ValueError):
        got_d.encode_first_stage(torch.from_numpy(four), stage)
    with pytest.raises(ValueError):
        got_d.decode_first_stage(torch.from_numpy(four), stage)
