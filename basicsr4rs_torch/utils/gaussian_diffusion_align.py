"""The align variant of the diffusion engine (counterpart of
``basicsr4rs_tpu/utils/gaussian_diffusion_align.py``; reference:
basicsr/utils/gaussian_diffusion_align.py): the first stage encodes and
decodes the whole tensor (no 3-band chunks, no ``scale_factor``), and its
encoding may keep its gradients, for a first stage trained with the
denoiser. NCHW."""

from __future__ import annotations

import contextlib
import torch

from ..archs.arch_util import resize_bicubic
from .gaussian_diffusion import (GaussianDiffusion, SpacedDiffusion, _randn_like,
                                 create_gaussian_diffusion)


def _gradients(keep: bool):
    return contextlib.nullcontext() if keep else torch.no_grad()


class GaussianDiffusionAlign(GaussianDiffusion):

    def decode_first_stage(self, z_sample, first_stage_model=None, no_grad: bool = True):
        if first_stage_model is None:
            return z_sample
        with _gradients(not no_grad):
            return first_stage_model.decode(z_sample)

    def encode_first_stage(self, y, first_stage_model=None, up_sample: bool = False,
                           no_grad: bool = True):
        if up_sample and self.sf != 1:
            y = resize_bicubic(y, float(self.sf))
        if first_stage_model is None:
            return y
        with _gradients(not no_grad):
            return first_stage_model.encode(y)

    def training_losses(self, generator, model, x_start, y, t, first_stage_model=None,
                        model_kwargs=None, noise=None, no_grad_encode: bool = True):
        """(loss_dict, z_t, pred_zstart) as the base engine's, the encodings
        with their gradients unless ``no_grad_encode``."""
        z_y = self.encode_first_stage(y, first_stage_model, up_sample=True,
                                      no_grad=no_grad_encode)
        z_start = self.encode_first_stage(x_start, first_stage_model, up_sample=False,
                                          no_grad=no_grad_encode)
        if noise is None:
            noise = _randn_like(z_start, generator)
        z_t = self.q_sample(z_start, z_y, t, noise)
        return self._losses(model, z_t, z_y, z_start, noise, t, model_kwargs or {})

    def denoise_prediction(self, generator, model, hr, lr, t, model_kwargs=None, noise=None):
        """The prediction of z_0 from q(z_t | hr, lr) of latents already
        encoded (``AlignJointDiffModel``'s step): ``noise`` when given, else
        drawn from ``generator``."""
        model_kwargs = model_kwargs or {}
        if noise is None:
            noise = _randn_like(hr, generator)
        z_t = self.q_sample(hr, lr, t, noise)
        return self._predict_xstart(z_t, lr, t, model(self._scale_input(z_t, t), t,
                                                      **model_kwargs))


class SpacedDiffusionAlign(SpacedDiffusion, GaussianDiffusionAlign):
    """The align process on a subset of the timesteps."""


def create_gaussian_diffusion_align(**kwargs):
    """``create_gaussian_diffusion``'s process on the align engine; it takes
    no ``scale_factor``: the align first stage's latents are not scaled."""
    if 'scale_factor' in kwargs:
        raise TypeError("create_gaussian_diffusion_align() got an unexpected keyword argument "
                        "'scale_factor'")
    return create_gaussian_diffusion(**kwargs, diffusion_class=SpacedDiffusionAlign)
