"""The port's alignment networks and losses (basicsr4rs_torch/archs/
arch_util.py's ChannelAttention, CAM and CAB, archs/alignae_arch.py,
archs/srcnn_arch.py, losses/align_loss.py) against the JAX package's on the same
numpy inputs, with the JAX modules' own initial weights carried over by
``jax_params_to_state_dict`` (every leaf first redrawn non-zero, so that no
zero-initialised layer hides what lies upstream of it). Float32 on the CPU;
outputs within 1e-5 of their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import alignae_arch as port_ae
from basicsr4rs_torch.archs import arch_util as port_util
from basicsr4rs_torch.archs.srcnn_arch import SRCNN
from basicsr4rs_torch.losses import align_loss as port_loss
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import alignae_arch as jax_ae
from basicsr4rs_tpu.archs import arch_util as jax_util
from basicsr4rs_tpu.archs import srcnn_arch as jax_srcnn
from basicsr4rs_tpu.losses import align_loss as jax_loss

TOL = 1e-5
AE = dict(num_in_ch=12, num_out_ch=6, num_feat=8, num_block=1)
LR = dict(num_in_ch=6, num_out_ch=6, num_feat=8, num_block=1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t.detach().numpy()).transpose(0, 2, 3, 1)


def assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f'{what}: {err:.3e}'


def redraw(params, seed):
    """Every leaf of a Flax tree redrawn, non-zero: kernels with std
    1/sqrt(fan-in), norm scales about 1, biases and tables small."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == 'kernel':
            return rng.normal(0, np.prod(shape[:-1])**-0.5, shape).astype(np.float32)
        if name == 'scale':
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_init(module, seed, *args, rules=None, **kwargs):
    """(JAX params, redrawn, as numpy; the port's state_dict of them under
    the port's key ``rules``). The init is jitted: un-jitted, a Flax init
    runs op by op."""
    params = jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(seed))
    params = redraw(params['params'], seed)
    return params, jax_params_to_state_dict(params, rules)


def jax_apply(module, params, *args, method=None):
    return jax.jit(lambda p, *a: module.apply({'params': p}, *a, method=method))(
        params, *[jnp.asarray(a) for a in args])


def port_of(cls, state_dict, *args, **kwargs):
    net = cls(*args, **kwargs)
    net.load_state_dict(state_dict)
    return net.eval()


def inputs(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


# ------------------------------------------------------------------ archs
@pytest.mark.parametrize('which', ['ChannelAttention', 'CAM', 'CAB'])
def test_channel_attention_blocks_match_jax(which):
    x = inputs(0, 2, 7, 9, 16)
    jax_cls, port_cls, args = {'ChannelAttention': (jax_util.ChannelAttention,
                                                    port_util.ChannelAttention, (16, 4)),
                               'CAM': (jax_util.CAM, port_util.CAM, (16,)),
                               'CAB': (jax_util.CAB, port_util.CAB, (16,))}[which]
    params, sd = jax_init(jax_cls(*args), 1, jnp.asarray(x),
                          rules=getattr(port_cls, 'JAX_KEY_RULES', None))
    want = jax_apply(jax_cls(*args), params, x)
    with torch.no_grad():
        got = port_of(port_cls, sd, *args)(nchw(x))
    assert_close(nhwc(got), want, which)


def test_align_autoencoder_and_lr_encoder_match_jax():
    """Stage 1 and stage 2, each AlignNet 2 larger than its input (the 1x1
    convolution with padding 1), and the LR encoder."""
    x = inputs(2, 2, 10, 11, 12)
    net = jax_ae.AlignAutoencoder(**AE)
    params, sd = jax_init(net, 2, jnp.asarray(x))
    want = jax_apply(net, params, x)
    port = port_of(port_ae.AlignAutoencoder, sd, **AE)
    assert sorted(sd) == sorted(port.state_dict())
    with torch.no_grad():
        got = port(nchw(x))
    assert got['stage1'].shape == (2, 6, 12, 13) and got['stage2'].shape == (2, 6, 14, 15)
    for key in ('stage1', 'stage2'):
        assert_close(nhwc(got[key]), want[key], key)
    x_lr = inputs(3, 2, 9, 9, 6)
    enc = jax_ae.LREncoder(**LR)
    params, sd = jax_init(enc, 3, jnp.asarray(x_lr))
    with torch.no_grad():
        got = port_of(port_ae.LREncoder, sd, **LR)(nchw(x_lr))
    assert_close(nhwc(got), jax_apply(enc, params, x_lr), 'LREncoder')
    assert port_ae.AlignAutoencoder is port_ae.ARCH_REGISTRY.get('StyleResNet')


def test_srcnn_matches_jax():
    """x3 on 6 bands: bicubic with align_corners, then the three convolutions."""
    x = inputs(4, 2, 8, 7, 6)
    net = jax_srcnn.SRCNN(num_in_ch=6, num_out_ch=6, upscale=3)
    params, sd = jax_init(net, 4, jnp.asarray(x))
    with torch.no_grad():
        got = port_of(SRCNN, sd, num_in_ch=6, num_out_ch=6, upscale=3)(nchw(x))
    assert got.shape == (2, 6, 24, 21)
    assert_close(nhwc(got), jax_apply(net, params, x), 'SRCNN')


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize('shifts', [[[0.0]], [[-1.5], [0.0], [0.25], [2.0]]],
                         ids=['zero', 'four'])
def test_lanczos_kernel_matches_jax(shifts):
    np.testing.assert_array_equal(port_loss.lanczos_kernel(np.array(shifts)),
                                  jax_loss.lanczos_kernel(np.array(shifts)))


def test_shift_bank_matches_jax():
    """All S x S shifted copies, y-shift major, (N, S^2, H, W, C) of the JAX
    package against the port's (N, S^2, C, H, W)."""
    x = inputs(8, 2, 13, 11, 3)
    want = np.asarray(jax_loss.ShiftBank(-1, 1, 0.5)(jnp.asarray(x)))
    got = port_loss.ShiftBank(-1, 1, 0.5)(nchw(x))
    assert got.shape == (2, 25, 3, 13, 11)
    assert_close(got.numpy().transpose(0, 1, 3, 4, 2), want, 'shift bank')


@pytest.mark.parametrize('loss_func', ['l1', 'mse'])
def test_registered_loss_matches_jax_and_finds_the_shift(loss_func):
    """On a copy shifted by 2 pixels the loss over the bank is near 0 where
    the unshifted loss is not (the JAX test's case), in both packages; and
    on a random pair, each reduction, the same number."""
    rng = np.random.RandomState(0)
    base = rng.rand(1, 24, 24, 2).astype(np.float32)
    shifted = np.roll(base, 2, axis=2)
    jax_l = jax_loss.RegisteredLoss(start=-3, end=3, step=1, loss_func=loss_func)
    port_l = port_loss.RegisteredLoss(start=-3, end=3, step=1, loss_func=loss_func)
    want = float(jax_l(jnp.asarray(base), jnp.asarray(shifted)))
    got = float(port_l(nchw(base), nchw(shifted)))
    plain = np.abs(base[:, 4:-4, 4:-4] - shifted[:, 4:-4, 4:-4])
    plain = float((plain if loss_func == 'l1' else plain**2).mean())
    assert got < plain * 0.35 and want < plain * 0.35, (got, want, plain)
    # near 0, the difference of two shifted copies of inputs of order 1, each
    # rounded at float32's 6e-8: held absolutely, to 1e-5 of the inputs' scale
    assert abs(got - want) <= TOL, (got, want)
    pred, target = inputs(9, 3, 20, 18, 2), inputs(10, 3, 20, 18, 2)
    for reduction in ('mean', 'sum', 'none'):
        kw = dict(start=-1, end=1, step=0.5, loss_func=loss_func, loss_weight=0.7,
                  reduction=reduction)
        assert_close(port_loss.RegisteredLoss(**kw)(nchw(pred), nchw(target)).numpy(),
                     jax_loss.RegisteredLoss(**kw)(jnp.asarray(pred), jnp.asarray(target)),
                     reduction)


def test_encoder_loss_matches_jax():
    z, gt, lq = inputs(11, 2, 12, 12, 3), inputs(12, 2, 12, 12, 3), inputs(13, 2, 4, 4, 3)
    for strategy in ('gt', 'lq'):
        for reduction in ('mean', 'sum', 'none'):
            kw = dict(strategy=strategy, reduction=reduction, loss_weight=0.5)
            got = port_loss.EncoderLoss(**kw)(nchw(z), nchw(gt), nchw(lq))
            want = jax_loss.EncoderLoss(**kw)(jnp.asarray(z), jnp.asarray(gt), jnp.asarray(lq))
            got = nhwc(got) if reduction == 'none' else got.numpy()
            assert_close(got, want, f'{strategy} {reduction}')
    for loss in (port_loss.EncoderLoss(strategy='lq'), jax_loss.EncoderLoss(strategy='lq')):
        with pytest.raises(ValueError, match='requires the lq argument'):
            loss(z, gt)
    with pytest.raises(ValueError):
        port_loss.EncoderLoss(strategy='nope')
