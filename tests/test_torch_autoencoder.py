"""The port's first-stage autoencoders
(basicsr4rs_torch/archs/autoencoder_arch.py) against the JAX package,
float32 on the CPU, same numpy inputs, the JAX module's parameters (every
leaf random) carried across by ``utils.jax_convert``. Encoder and decoder
within 1e-4 of the output's largest entry. The quantizer is an argmin over
the codebook, where a last-bit difference in a distance can pick another
code: encoder, decoder (``force_not_quantize``) and code indices are held
separately, and an index may differ only where the two smallest distances
are within 1e-5 of each other."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import autoencoder_arch as port
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import autoencoder_arch as ref

from test_torch_swinir import _randomize
from test_torch_unet import assert_close_rel, nchw, nhwc

DD = dict(ch=8, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
          in_channels=3, resolution=16, z_channels=3, double_z=False, padding_mode='zeros')
RULES = port.VQModelTorch.JAX_KEY_RULES


@functools.lru_cache(maxsize=None)
def _vq(n_embed=32, seed=0):
    jnet = ref.VQModelTorch(ddconfig=DD, n_embed=n_embed, embed_dim=3)
    x0 = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x0)['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(seed))
    # codes spread over the latents' range, so that many are in use
    params['quantize']['embedding'] = np.random.RandomState(seed + 1).randn(
        n_embed, 3).astype(np.float32)
    net = port.VQModelTorch(ddconfig=DD, n_embed=n_embed, embed_dim=3)
    net.load_state_dict(jax_params_to_state_dict(params, RULES))
    return jnet, params, net.eval()


def _apply(jnet, params, method, *args, **kwargs):
    return jnet.apply({'params': params}, *args, method=method, **kwargs)


def test_published_key_names():
    keys = set(port.VQModelTorch(ddconfig=DD, n_embed=8, embed_dim=3).state_dict())
    for key in ('encoder.conv_in.weight', 'encoder.down.0.block.0.norm1.weight',
                'encoder.down.0.downsample.conv.weight', 'encoder.down.1.attn.0.q.weight',
                'encoder.down.1.block.0.nin_shortcut.weight', 'encoder.mid.block_1.conv1.bias',
                'encoder.mid.attn_1.proj_out.weight', 'encoder.norm_out.weight',
                'decoder.up.1.upsample.conv.weight', 'decoder.up.0.block.1.conv2.weight',
                'decoder.conv_out.bias', 'quantize.embedding.weight', 'quant_conv.weight',
                'post_quant_conv.bias'):
        assert key in keys, key


def test_vq_encoder_matches_jax():
    jnet, params, net = _vq()
    x = np.random.RandomState(2).randn(2, 3, 16, 16).astype(np.float32)
    want = nchw(_apply(jnet, params, ref.VQModelTorch.encode, nhwc(x)))
    got = net.encode(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 3, 8, 8)
    assert_close_rel(got, want, 1e-4)


def test_vq_decoder_without_quantizer_matches_jax():
    jnet, params, net = _vq()
    h = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    want = nchw(_apply(jnet, params, ref.VQModelTorch.decode, nhwc(h), force_not_quantize=True))
    got = net.decode(torch.from_numpy(h), force_not_quantize=True).detach().numpy()
    assert got.shape == (2, 3, 16, 16)
    assert_close_rel(got, want, 1e-4)


@pytest.mark.parametrize('n_embed', [32, 512])
def test_vq_code_indices_match_jax_up_to_ties(n_embed):
    jnet, params, net = _vq(n_embed)
    h = np.random.RandomState(4).randn(2, 3, 8, 8).astype(np.float32)
    (_, want_loss, want_idx) = ref.VectorQuantizer(n_embed, 3).apply(
        {'params': params['quantize']}, nhwc(h))
    z_q, loss, idx = net.quantize(torch.from_numpy(h))
    want_idx, idx = np.asarray(want_idx), idx.numpy()
    assert idx.shape == want_idx.shape == (2, 8, 8)
    assert len(np.unique(idx)) > 4
    differ = idx != want_idx
    if differ.any():   # only where the two codes are equally near
        d = net.quantize.distances(torch.from_numpy(h)).detach().numpy().reshape(2, 8, 8, -1)
        near = np.take_along_axis(d, idx[..., None], -1)[..., 0]
        other = np.take_along_axis(d, want_idx[..., None], -1)[..., 0]
        assert np.abs(near - other)[differ].max() <= 1e-5
    else:
        assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    # straight-through: the values are the codes, the gradient is the identity
    codes = net.quantize.embedding.weight.detach().numpy()[idx]
    np.testing.assert_allclose(z_q.detach().numpy(), codes.transpose(0, 3, 1, 2), atol=1e-6)


def test_vq_whole_model_matches_jax_where_the_codes_agree():
    jnet, params, net = _vq(32)
    x = np.random.RandomState(5).randn(1, 3, 16, 16).astype(np.float32)
    want = nchw(jnet.apply({'params': params}, nhwc(x)))
    got = net(torch.from_numpy(x)).detach().numpy()
    idx = net.quantize(net.encode(torch.from_numpy(x)))[2].numpy()
    want_idx = np.asarray(ref.VectorQuantizer(32, 3).apply(
        {'params': params['quantize']},
        _apply(jnet, params, ref.VQModelTorch.encode, nhwc(x)))[2])
    if (idx == want_idx).all():
        assert_close_rel(got, want, 1e-4)
    assert got.shape == (1, 3, 16, 16) and np.isfinite(got).all()


def test_frozen_first_stage_passes_gradients_straight_through():
    _, _, net = _vq()
    h = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)
    z_q, loss, _ = net.quantize(h)
    z_q.sum().backward()
    assert torch.equal(h.grad, torch.ones_like(h))
    assert loss.requires_grad


KL_DD = dict(DD, double_z=True, z_channels=4, attn_resolutions=())


def _kl(seed=6):
    jnet = ref.AutoencoderKLTorch(ddconfig=KL_DD, embed_dim=4)
    x0 = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x0)['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(seed))
    net = port.AutoencoderKLTorch(ddconfig=KL_DD, embed_dim=4)
    net.load_state_dict(jax_params_to_state_dict(params, RULES))
    return jnet, params, net.eval()


def test_kl_encode_mode_moments_and_decode_match_jax():
    jnet, params, net = _kl()
    x = np.random.RandomState(7).randn(2, 3, 16, 16).astype(np.float32)
    want_z, want_m = _apply(jnet, params, ref.AutoencoderKLTorch.encode, nhwc(x),
                            return_moments=True)
    z, moments = net.encode(torch.from_numpy(x), return_moments=True)
    assert z.shape == (2, 4, 8, 8) and moments.shape == (2, 8, 8, 8)
    assert_close_rel(z.detach().numpy(), nchw(want_z), 1e-4)
    assert_close_rel(moments.detach().numpy(), nchw(want_m), 1e-4)
    want = nchw(_apply(jnet, params, ref.AutoencoderKLTorch.decode, want_z))
    got = net.decode(torch.from_numpy(nchw(want_z))).detach().numpy()
    assert_close_rel(got, want, 1e-4)


def test_kl_sample_with_given_noise_and_distribution_terms_match_jax():
    rng = np.random.RandomState(8)
    moments = rng.randn(2, 8, 4, 4).astype(np.float32) * 3
    noise = rng.randn(2, 4, 4, 4).astype(np.float32)
    sample = rng.randn(2, 4, 4, 4).astype(np.float32)
    want = ref.DiagonalGaussianDistribution(nhwc(moments))
    got = port.DiagonalGaussianDistribution(torch.from_numpy(moments))
    np.testing.assert_allclose(got.sample(noise=torch.from_numpy(noise)).numpy(),
                               nchw(want.mean + want.std * nhwc(noise)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(want.kl()), rtol=1e-5)
    other_m = rng.randn(2, 8, 4, 4).astype(np.float32)
    np.testing.assert_allclose(
        got.kl(port.DiagonalGaussianDistribution(torch.from_numpy(other_m))).numpy(),
        np.asarray(want.kl(ref.DiagonalGaussianDistribution(nhwc(other_m)))), rtol=1e-5)
    np.testing.assert_allclose(got.nll(torch.from_numpy(sample)).numpy(),
                               np.asarray(want.nll(nhwc(sample))), rtol=1e-5)
    drawn = got.sample(torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 4, 4, 4) and torch.isfinite(drawn).all()


def test_identity_first_stage():
    net = port.IdentityFirstStage()
    x = torch.ones(1, 3, 4, 4)
    assert net.encode(x) is x and net.decode(x) is x and net(x) is x
