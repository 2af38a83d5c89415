"""ResShift's residual-shifting diffusion engine (counterpart of
``basicsr4rs_tpu/utils/gaussian_diffusion.py``; reference:
basicsr/utils/gaussian_diffusion.py).

The forward process shifts x_t from x_0 toward the LQ latent y:

    q(x_t | x_0, y) = N(x_t; x_0 + eta_t (y - x_0), kappa^2 eta_t I)

The schedule tables are numpy float64 and are cast to float32 where they
are gathered per sample. Randomness comes from an explicit
``torch.Generator`` or from noise handed in; the reverse chain
``p_sample_loop`` is a Python loop over the timesteps. NCHW.
"""

from __future__ import annotations

import enum
import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..archs.arch_util import resize_bicubic


def get_named_eta_schedule(schedule_name: str, num_diffusion_timesteps: int,
                           min_noise_level: float, etas_end: float = 0.99, kappa: float = 1.0,
                           kwargs: Optional[dict] = None) -> np.ndarray:
    """sqrt(eta_t) for every timestep, float64."""
    kwargs = kwargs or {}
    if schedule_name == 'exponential':
        power = kwargs.get('power', None)
        etas_start = min(min_noise_level / kappa, min_noise_level)
        increaser = math.exp(1 / (num_diffusion_timesteps - 1) * math.log(etas_end / etas_start))
        base = np.ones([num_diffusion_timesteps]) * increaser
        power_timestep = np.linspace(0, 1, num_diffusion_timesteps, endpoint=True)**power
        power_timestep *= (num_diffusion_timesteps - 1)
        sqrt_etas = np.power(base, power_timestep) * etas_start
    elif schedule_name == 'ldm':
        import scipy.io as sio
        sqrt_etas = sio.loadmat(kwargs.get('mat_path'))['sqrt_etas'].reshape(-1)
    else:
        raise ValueError(f'Unknown schedule_name {schedule_name}')
    return sqrt_etas


class ModelMeanType(enum.Enum):
    START_X = enum.auto()
    EPSILON = enum.auto()
    PREVIOUS_X = enum.auto()
    RESIDUAL = enum.auto()
    EPSILON_SCALE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    WEIGHTED_MSE = enum.auto()


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """The schedule's values at the (B,) timesteps ``t`` as float32, shaped
    (B, 1, ...) to broadcast over ``ndim`` dimensions."""
    vals = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


def _randn_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal noise of x's shape and dtype on x's device, drawn on
    the generator's device (torch's global generator of x's device when None)."""
    draw_on = x.device if generator is None else generator.device
    return torch.randn(x.shape, generator=generator, device=draw_on, dtype=x.dtype).to(x.device)


class GaussianDiffusion:

    def __init__(self, *, sqrt_etas, kappa, model_mean_type, loss_type, sf=4,
                 scale_factor=None, normalize_input=True, latent_flag=True):
        self.kappa = kappa
        self.model_mean_type = model_mean_type
        self.loss_type = loss_type
        self.scale_factor = scale_factor
        self.normalize_input = normalize_input
        self.latent_flag = latent_flag
        self.sf = sf

        self.sqrt_etas = np.asarray(sqrt_etas, np.float64)
        self.etas = self.sqrt_etas**2
        if not (self.etas.ndim == 1 and (self.etas > 0).all() and (self.etas <= 1).all()):
            raise ValueError('etas must be a vector of values in (0, 1]')
        self.num_timesteps = int(self.etas.shape[0])
        self.etas_prev = np.append(0.0, self.etas[:-1])
        self.alpha = self.etas - self.etas_prev

        self.posterior_variance = kappa**2 * self.etas_prev / self.etas * self.alpha
        self.posterior_variance_clipped = np.append(self.posterior_variance[1],
                                                    self.posterior_variance[1:])
        self.posterior_log_variance_clipped = np.log(self.posterior_variance_clipped)
        self.posterior_mean_coef1 = self.etas_prev / self.etas
        self.posterior_mean_coef2 = self.alpha / self.etas

        if model_mean_type in (ModelMeanType.START_X, ModelMeanType.RESIDUAL):
            weight_loss_mse = 0.5 / self.posterior_variance_clipped * (self.alpha / self.etas)**2
        elif model_mean_type in (ModelMeanType.EPSILON, ModelMeanType.EPSILON_SCALE):
            weight_loss_mse = 0.5 / self.posterior_variance_clipped * (
                kappa * self.alpha / ((1 - self.etas) * self.sqrt_etas))**2
        else:
            raise NotImplementedError(model_mean_type)
        self.weight_loss_mse = weight_loss_mse

    # ------------------------------------------------------------- forward q
    def q_mean_variance(self, x_start, y, t):
        mean = _extract(self.etas, t, x_start.dim()) * (y - x_start) + x_start
        variance = _extract(self.etas, t, x_start.dim()) * self.kappa**2
        return mean, variance, variance.log()

    def q_sample(self, x_start, y, t, noise):
        if noise.shape != x_start.shape:
            raise ValueError('q_sample: noise must have x_start\'s shape')
        return (_extract(self.etas, t, x_start.dim()) * (y - x_start) + x_start
                + _extract(self.sqrt_etas * self.kappa, t, x_start.dim()) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        posterior_mean = (_extract(self.posterior_mean_coef1, t, x_t.dim()) * x_t
                          + _extract(self.posterior_mean_coef2, t, x_t.dim()) * x_start)
        posterior_variance = _extract(self.posterior_variance, t, x_t.dim())
        posterior_log_variance = _extract(self.posterior_log_variance_clipped, t, x_t.dim())
        return posterior_mean, posterior_variance, posterior_log_variance

    # ------------------------------------------------------------- reverse p
    def p_mean_variance(self, model, x_t, y, t, clip_denoised=True, denoised_fn=None,
                        model_kwargs=None):
        model_kwargs = model_kwargs or {}
        model_output = model(self._scale_input(x_t, t), t, **model_kwargs)
        model_variance = _extract(self.posterior_variance, t, x_t.dim())
        model_log_variance = _extract(self.posterior_log_variance_clipped, t, x_t.dim())

        def process_xstart(x):
            if denoised_fn is not None:
                x = denoised_fn(x)
            if clip_denoised:
                x = x.clamp(-1, 1)
            return x

        pred_xstart = process_xstart(self._predict_xstart(x_t, y, t, model_output))
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x_t, t)
        return {'mean': model_mean, 'variance': model_variance,
                'log_variance': model_log_variance, 'pred_xstart': pred_xstart}

    def _predict_xstart(self, x_t, y, t, model_output):
        """x_0 from the model's output, by what the model predicts."""
        if self.model_mean_type == ModelMeanType.START_X:
            return model_output
        if self.model_mean_type == ModelMeanType.RESIDUAL:
            return self._predict_xstart_from_residual(y, model_output)
        if self.model_mean_type == ModelMeanType.EPSILON:
            return self._predict_xstart_from_eps(x_t, y, t, model_output)
        if self.model_mean_type == ModelMeanType.EPSILON_SCALE:
            return self._predict_xstart_from_eps_scale(x_t, y, t, model_output)
        raise ValueError(f'Unknown Mean type: {self.model_mean_type}')

    def _predict_xstart_from_eps(self, x_t, y, t, eps):
        return ((x_t - _extract(self.sqrt_etas, t, x_t.dim()) * self.kappa * eps
                 - _extract(self.etas, t, x_t.dim()) * y)
                / _extract(1 - self.etas, t, x_t.dim()))

    def _predict_xstart_from_eps_scale(self, x_t, y, t, eps):
        return ((x_t - eps - _extract(self.etas, t, x_t.dim()) * y)
                / _extract(1 - self.etas, t, x_t.dim()))

    def _predict_xstart_from_residual(self, y, residual):
        return y - residual

    def _predict_eps_from_xstart(self, x_t, y, t, pred_xstart):
        return ((x_t - _extract(1 - self.etas, t, x_t.dim()) * pred_xstart
                 - _extract(self.etas, t, x_t.dim()) * y)
                / _extract(self.kappa * self.sqrt_etas, t, x_t.dim()))

    def p_sample(self, generator, model, x, y, t, clip_denoised=True, denoised_fn=None,
                 model_kwargs=None, noise_repeat=False, noise=None):
        """One reverse step. The step's noise is ``noise`` when given, else
        drawn from ``generator``."""
        out = self.p_mean_variance(model, x, y, t, clip_denoised, denoised_fn, model_kwargs)
        if noise is None:
            noise = _randn_like(x, generator)
        if noise_repeat:
            noise = noise[:1].repeat(x.shape[0], *([1] * (x.dim() - 1)))
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
        sample = out['mean'] + nonzero_mask * torch.exp(0.5 * out['log_variance']) * noise
        return {'sample': sample, 'pred_xstart': out['pred_xstart'], 'mean': out['mean']}

    def p_sample_loop(self, generator, y, model, first_stage_model=None, noise=None,
                      noise_repeat=False, clip_denoised=True, denoised_fn=None,
                      model_kwargs=None, step_noise: Optional[Sequence[torch.Tensor]] = None):
        """The whole reverse chain, from q(x_T | y) down to t = 0, then the
        first stage's decoder.

        ``model`` is ``model(x, t, **kwargs) -> output``; ``first_stage_model``
        has ``encode`` and ``decode``. ``noise`` is the prior sample's noise
        and ``step_noise`` one tensor per reverse step in the order the
        steps run (t = T-1 first); each is drawn from ``generator`` when not
        given. Runs without gradients."""
        with torch.no_grad():
            z_y = self.encode_first_stage(y, first_stage_model, up_sample=True)
            if noise is None:
                noise = _randn_like(z_y, generator)
            if noise_repeat:
                noise = noise[:1].repeat(z_y.shape[0], *([1] * (z_y.dim() - 1)))
            z = self.prior_sample(z_y, noise)
            for k, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
                t = torch.full((z_y.shape[0],), i, dtype=torch.long, device=z_y.device)
                out = self.p_sample(generator, model, z, z_y, t, clip_denoised, denoised_fn,
                                    model_kwargs, noise_repeat,
                                    noise=None if step_noise is None else step_noise[k])
                z = out['sample']
            return self.decode_first_stage(z, first_stage_model)

    # --------------------------------------------------- first-stage coding
    def decode_first_stage(self, z_sample, first_stage_model=None, split_channels: int = 3):
        """Decode ``split_channels`` latent channels at a time, without
        gradients through the first stage's weights."""
        if first_stage_model is None:
            return z_sample
        self._check_scale_factor()
        z_sample = z_sample / self.scale_factor
        c = z_sample.shape[1]
        if c % split_channels:
            raise ValueError(f'channels {c} not divisible by {split_channels}')
        decoded = [first_stage_model.decode(chunk) for chunk in z_sample.split(split_channels, 1)]
        return torch.cat(decoded, dim=1)

    def encode_first_stage(self, y, first_stage_model=None, up_sample=False,
                           split_channels: int = 3):
        if up_sample and self.sf != 1:
            y = resize_bicubic(y, float(self.sf))
        if first_stage_model is None:
            return y
        self._check_scale_factor()
        c = y.shape[1]
        if c % split_channels:
            raise ValueError(f'channels {c} not divisible by {split_channels}')
        encoded = [first_stage_model.encode(chunk) * self.scale_factor
                   for chunk in y.split(split_channels, 1)]
        return torch.cat(encoded, dim=1)

    def _check_scale_factor(self):
        """A first stage scales its latents by ``scale_factor``: without one
        (``None``) the coding stops here, where the JAX package's stops at the
        multiplication."""
        if self.scale_factor is None:
            raise TypeError('the diffusion has a first stage but its scale_factor is None')

    def prior_sample(self, y, noise):
        """A sample of q(x_T | y)."""
        t = torch.full((y.shape[0],), self.num_timesteps - 1, dtype=torch.long, device=y.device)
        return y + _extract(self.kappa * self.sqrt_etas, t, y.dim()) * noise

    # ------------------------------------------------------------- training
    def training_losses(self, generator, model, x_start, y, t, first_stage_model=None,
                        model_kwargs=None, noise=None):
        """(loss_dict, z_t, pred_zstart); ``loss_dict['mse']`` is per sample.
        The first stage encodes without gradients."""
        with torch.no_grad():
            z_y = self.encode_first_stage(y, first_stage_model, up_sample=True)
            z_start = self.encode_first_stage(x_start, first_stage_model, up_sample=False)
            if noise is None:
                noise = _randn_like(z_start, generator)
            z_t = self.q_sample(z_start, z_y, t, noise)
        return self._losses(model, z_t, z_y, z_start, noise, t, model_kwargs or {})

    def _losses(self, model, z_t, z_y, z_start, noise, t, model_kwargs):
        """(loss_dict, z_t, pred_zstart) of the model's output at z_t."""
        loss_dict = OrderedDict()
        model_output = model(self._scale_input(z_t, t), t, **model_kwargs)
        target = {
            ModelMeanType.START_X: z_start,
            ModelMeanType.RESIDUAL: z_y - z_start,
            ModelMeanType.EPSILON: noise,
            ModelMeanType.EPSILON_SCALE:
                noise * self.kappa * _extract(self.sqrt_etas, t, noise.dim()),
        }[self.model_mean_type]
        mse = mean_flat((target - model_output.float())**2)
        if self.model_mean_type == ModelMeanType.EPSILON_SCALE:
            mse = mse / (self.kappa**2 * _extract(self.etas, t, 1))
        if self.loss_type == LossType.WEIGHTED_MSE:
            mse = mse * _extract(self.weight_loss_mse, t, 1)
        loss_dict['mse'] = mse
        return loss_dict, z_t, self._predict_xstart(z_t, z_y, t, model_output)

    def _scale_input(self, inputs, t):
        if not self.normalize_input:
            return inputs
        if self.latent_flag:
            std = torch.sqrt(_extract(self.etas, t, inputs.dim()) * self.kappa**2 + 1)
            return inputs / std
        inputs_max = _extract(self.sqrt_etas, t, inputs.dim()) * self.kappa * 3 + 1
        return inputs / inputs_max


class SpacedDiffusion(GaussianDiffusion):
    """The process on a subset of the timesteps."""

    def __init__(self, use_timesteps, **kwargs):
        self.use_timesteps = set(use_timesteps)
        self.timestep_map = []
        self.original_num_steps = len(kwargs['sqrt_etas'])
        base = GaussianDiffusion(**kwargs)
        new_sqrt_etas = []
        for ii, v in enumerate(base.sqrt_etas):
            if ii in self.use_timesteps:
                new_sqrt_etas.append(v)
                self.timestep_map.append(ii)
        kwargs['sqrt_etas'] = np.array(new_sqrt_etas)
        super().__init__(**kwargs)


def space_timesteps(num_timesteps: int, sample_timesteps: int):
    return set(int((num_timesteps / sample_timesteps) * x) for x in range(sample_timesteps))


def create_gaussian_diffusion(*, normalize_input, schedule_name, sf=4, min_noise_level=0.01,
                              steps=1000, kappa=1, etas_end=0.99, schedule_kwargs=None,
                              weighted_mse=False, predict_type='xstart',
                              timestep_respacing=None, scale_factor=None, latent_flag=True,
                              diffusion_class=SpacedDiffusion):
    sqrt_etas = get_named_eta_schedule(schedule_name, num_diffusion_timesteps=steps,
                                       min_noise_level=min_noise_level, etas_end=etas_end,
                                       kappa=kappa, kwargs=schedule_kwargs)
    if timestep_respacing is None:
        timestep_respacing = steps
    elif not isinstance(timestep_respacing, int):
        raise TypeError('timestep_respacing must be an int or None')
    model_mean_type = {
        'xstart': ModelMeanType.START_X,
        'epsilon': ModelMeanType.EPSILON,
        'epsilon_scale': ModelMeanType.EPSILON_SCALE,
        'residual': ModelMeanType.RESIDUAL,
    }[predict_type]
    return diffusion_class(
        use_timesteps=space_timesteps(steps, timestep_respacing),
        sqrt_etas=sqrt_etas, kappa=kappa, model_mean_type=model_mean_type,
        loss_type=LossType.WEIGHTED_MSE if weighted_mse else LossType.MSE,
        scale_factor=scale_factor, normalize_input=normalize_input, sf=sf,
        latent_flag=latent_flag)
