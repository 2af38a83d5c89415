"""The port's joint network and align diffusion engine
(basicsr4rs_torch/archs/alignae_unet_arch.py, utils/gaussian_diffusion_align.py)
against the JAX package's on the same numpy inputs, the JAX modules' weights
carried over as in ``test_torch_align.py``. Float32 on the CPU; outputs
within 1e-5 of their largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import alignae_arch as port_ae
from basicsr4rs_torch.archs.alignae_unet_arch import ResNetAE_SwinUNet
from basicsr4rs_torch.models.align_frozen_diff_model import AlignFirstStage
from basicsr4rs_torch.utils import gaussian_diffusion_align as port_gda
from basicsr4rs_tpu.archs import alignae_arch as jax_ae
from basicsr4rs_tpu.archs import alignae_unet_arch as jax_aeu
from basicsr4rs_tpu.models.align_frozen_diff_model import _AlignFirstStage
from basicsr4rs_tpu.utils import gaussian_diffusion_align as jax_gda

from test_torch_align import AE, LR, assert_close, inputs, jax_apply, jax_init, nchw, nhwc, port_of

# the joint network at test width: a two-level UNet of 8 channels (GroupNorm
# takes min(32, C) groups), Swin 8 in heads of 4, window 4, its Swin layers
# at 16 and in the middle (8x8: four windows, then shifted)
UNET = dict(image_size=16, in_channels=6, model_channels=8, out_channels=6, num_res_blocks=1,
            attention_resolutions=[16], channel_mult=[1, 2], num_head_channels=4,
            swin_embed_dim=8, window_size=4, mlp_ratio=4, use_scale_shift_norm=True,
            cond_lq=True, lq_size=16)
DIFFUSION = dict(normalize_input=True, schedule_name='exponential', sf=3, min_noise_level=0.2,
                 steps=3, kappa=2.0, etas_end=0.99, schedule_kwargs={'power': 0.3},
                 predict_type='xstart', timestep_respacing=None, latent_flag=False)


def test_resnetae_swinunet_methods_match_jax():
    """The four methods the joint model calls: the UNet (with its Swin
    layers) on a latent and the LR latent, the align encoder and decoder,
    the LR encoder."""
    net = jax_aeu.ResNetAE_SwinUNet(unet_args=UNET, align_autoencoder_args=AE,
                                    lr_encoder_args=LR)
    x, lq = inputs(5, 2, 16, 16, 6), inputs(6, 2, 16, 16, 6)
    t = np.array([0, 2])
    params, sd = jax_init(net, 5, jnp.asarray(x), jnp.asarray(t), lq=jnp.asarray(lq),
                          rules=ResNetAE_SwinUNet.JAX_KEY_RULES)
    port = port_of(ResNetAE_SwinUNet, sd, UNET, AE, LR)
    assert sorted(sd) == sorted(port.state_dict())
    cls = jax_aeu.ResNetAE_SwinUNet

    reg = inputs(7, 2, 16, 16, 12)
    with torch.no_grad():
        cases = [('apply_unet', port.apply_unet(nchw(x), torch.from_numpy(t), nchw(lq)),
                  jax_apply(net, params, x, t, lq, method=cls.apply_unet)),
                 ('apply_ae_encode', port.apply_ae_encode(nchw(reg)),
                  jax_apply(net, params, reg, method=cls.apply_ae_encode)),
                 ('apply_ae_decode', port.apply_ae_decode(nchw(x)),
                  jax_apply(net, params, x, method=cls.apply_ae_decode)),
                 ('apply_lr_encode', port.apply_lr_encode(nchw(lq)),
                  jax_apply(net, params, lq, method=cls.apply_lr_encode))]
    for name, got, want in cases:
        assert_close(nhwc(got), want, name)


# ------------------------------------------------------- diffusion engine
@pytest.fixture(scope='module')
def engines():
    """Both packages' align engines over one frozen AlignAutoencoder first
    stage, its encoding cropped to a 12x12 latent."""
    net = jax_ae.AlignAutoencoder(**AE)
    params, sd = jax_init(net, 14, jnp.zeros((1, 12, 12, 12)))
    port_stage = AlignFirstStage(port_of(port_ae.AlignAutoencoder, sd, **AE), latent_size=12)
    jax_stage = _AlignFirstStage(net, params, 12, latent_size=12)
    return (port_gda.create_gaussian_diffusion_align(**DIFFUSION), port_stage,
            jax_gda.create_gaussian_diffusion_align(**DIFFUSION), jax_stage)


def models():
    """A denoiser for each package that depends on x and t."""
    def port_model(x, t):
        return torch.tanh(1.5 * x) * (1 + t.float().view(-1, 1, 1, 1) / 4)

    def jax_model(x, t):
        return jnp.tanh(1.5 * x) * (1 + t.astype(jnp.float32).reshape(-1, 1, 1, 1) / 4)
    return port_model, jax_model


def test_align_diffusion_training_losses_match_jax(engines):
    """``training_losses`` at fixed timesteps and noise: the registration
    input (12 bands) and the LQ (6, x3, then beside itself) through the
    first stage, the per-sample MSE, z_t and the predicted z_0."""
    port_d, port_stage, jax_d, jax_stage = engines
    reg, lq = inputs(15, 2, 10, 10, 12), inputs(16, 2, 4, 4, 6)
    t, noise = np.array([0, 2]), inputs(17, 2, 12, 12, 6)
    port_model, jax_model = models()
    got = port_d.training_losses(None, port_model, nchw(reg), nchw(lq), torch.from_numpy(t),
                                 first_stage_model=port_stage, noise=nchw(noise))
    want = jax_d.training_losses(None, jax_model, jnp.asarray(reg), jnp.asarray(lq),
                                 jnp.asarray(t), first_stage_model=jax_stage,
                                 noise=jnp.asarray(noise))
    assert_close(got[0]['mse'].numpy(), want[0]['mse'], 'mse')
    assert_close(nhwc(got[1]), want[1], 'z_t')
    assert_close(nhwc(got[2]), want[2], 'pred z_0')
    assert not got[1].requires_grad


def test_align_diffusion_denoise_prediction_and_coding_match_jax(engines):
    port_d, port_stage, jax_d, jax_stage = engines
    hr, lr = inputs(18, 2, 12, 12, 6), inputs(19, 2, 12, 12, 6)
    t, noise = np.array([1, 2]), inputs(20, 2, 12, 12, 6)
    port_model, jax_model = models()
    got = port_d.denoise_prediction(None, port_model, nchw(hr), nchw(lr), torch.from_numpy(t),
                                    noise=nchw(noise))
    want = jax_d.denoise_prediction(None, jax_model, jnp.asarray(hr), jnp.asarray(lr),
                                    jnp.asarray(t), noise=jnp.asarray(noise))
    assert_close(nhwc(got), want, 'denoise_prediction')
    lq = inputs(21, 2, 4, 4, 6)
    with torch.no_grad():
        z = port_d.encode_first_stage(nchw(lq), port_stage, up_sample=True)
        back = port_d.decode_first_stage(z, port_stage)
    jz = jax_d.encode_first_stage(jnp.asarray(lq), jax_stage, up_sample=True)
    assert z.shape == (2, 6, 12, 12)
    assert_close(nhwc(z), jz, 'encode (x3, beside itself, cropped)')
    assert_close(nhwc(back), jax_d.decode_first_stage(jz, jax_stage), 'decode')
