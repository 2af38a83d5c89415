"""The port's ``AlignFrozenDiffModel`` (basicsr4rs_torch/models/
align_frozen_diff_model.py) against the JAX package's on the JAX test
config's path: the loss of one step at the timesteps and noise the JAX step
draws, through a frozen align autoencoder, as ``test_torch_align_models.py``
holds the other two alignment models. Float32 on the CPU."""

import copy

import pytest
import torch

from test_torch_align import AE, nchw
from test_torch_align_models import (DIFFUSION, TOL, UNET, build_pair, l2s_batch, model_opt,
                                     step_draws)


def test_align_frozen_diff_model_loss_matches_jax():
    """AlignFrozenDiffModel (the JAX test config's path): the loss of one
    step at the JAX step's timesteps and noise, through the frozen align
    autoencoder's latents cropped to image_size."""
    opt = model_opt('AlignFrozenDiffModel', dict(type='UNetModelSwin', lq_channels=6, **UNET),
                    {}, autoencoder=dict(type='AlignAutoencoder', **AE),
                    diffusion=copy.deepcopy(DIFFUSION))
    port, jax_model, _ = build_pair(opt, 1)
    jax_batch, port_batch = l2s_batch(1)
    tt, noise = step_draws(jax_model, (2, 24, 24, 6))
    port.feed_data(dict(port_batch, tt=torch.from_numpy(tt), noise=nchw(noise)))
    jax_model.feed_data(jax_batch)
    port.optimize_parameters(1)
    jax_model.optimize_parameters(1)
    got, want = port.get_current_log(), jax_model.get_current_log()
    assert list(got) == list(want) == ['loss', 'mse']
    assert got['loss'] == pytest.approx(want['loss'], rel=TOL)
    assert not any(p.requires_grad for p in port.first_stage.net.parameters())
