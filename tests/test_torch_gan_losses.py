"""The port's GAN losses, VGG feature extractor, perceptual loss and
discriminators (basicsr4rs_torch/losses/gan_loss.py, perceptual_loss.py,
archs/vgg_arch.py, archs/discriminator_arch.py) against the JAX package's
on the same numpy inputs and weights. The VGG weights are a random
torchvision-format VGG19 ``.pth`` that both packages read. Float32 on the
CPU: losses and outputs within 1e-5 of their scale, gradients within 1e-4
of their largest entry (a gradient through 16 convolutions and a norm)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import discriminator_arch as port_disc
from basicsr4rs_torch.archs.vgg_arch import VGGFeatureExtractor, vgg_layer_names
from basicsr4rs_torch.losses.gan_loss import GANLoss, MultiScaleGANLoss
from basicsr4rs_torch.losses.perceptual_loss import PerceptualLoss, gram
from basicsr4rs_tpu.archs import discriminator_arch as jax_disc
from basicsr4rs_tpu.archs import vgg_arch as jax_vgg
from basicsr4rs_tpu.losses import gan_loss as jax_gan
from basicsr4rs_tpu.losses import perceptual_loss as jax_percep
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

TOL, GRAD_TOL = 1e-5, 1e-4
VGG19_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512, 512, 512, 512]


def write_vgg19(path, seed=0, convs=16):
    """A random VGG19 in torchvision's layout (``features.<index>``): the
    first ``convs`` convolutions at He scale, so that deep features keep
    their size."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    conv_index = [i for i, n in enumerate(vgg_layer_names('vgg19')) if n.startswith('conv')]
    for i, cout in zip(conv_index[:convs], VGG19_CHANNELS):
        sd[f'features.{i}.weight'] = torch.from_numpy(
            rng.normal(0, (2 / (9 * cin))**0.5, (cout, cin, 3, 3)).astype(np.float32))
        sd[f'features.{i}.bias'] = torch.from_numpy((0.01 * rng.normal(size=cout)).astype(
            np.float32))
        cin = cout
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope='module')
def vgg_path(tmp_path_factory):
    return write_vgg19(tmp_path_factory.mktemp('vgg') / 'vgg19.pth')


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f'{what}: {err:.3e}'


# ------------------------------------------------------------------ GAN losses
@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan', 'wgan_softplus', 'hinge'])
@pytest.mark.parametrize('target_is_real', [True, False])
@pytest.mark.parametrize('is_disc', [True, False])
def test_gan_loss_matches_jax(gan_type, target_is_real, is_disc):
    """Each type, label and side, with labels off 1/0 and a weight that only
    the generator's terms take; the value and its gradient."""
    pred = np.random.RandomState(1).uniform(-4, 4, (2, 1, 5, 5)).astype(np.float32)
    kwargs = dict(gan_type=gan_type, real_label_val=0.9, fake_label_val=0.1, loss_weight=0.3)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_gan.GANLoss(**kwargs)(p, target_is_real, is_disc))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = GANLoss(**kwargs)(p, target_is_real, is_disc)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=TOL, abs=1e-7)
    assert_close(p.grad.numpy(), want_grad, 'gradient')


def test_gan_loss_refuses_an_unknown_type():
    with pytest.raises(NotImplementedError):
        GANLoss('relativistic')


def test_multiscale_gan_loss_matches_jax():
    """A list of predictions, one of them a list (its last entry counts),
    and a single prediction."""
    rng = np.random.RandomState(2)
    preds = [rng.randn(2, 1, 8, 8).astype(np.float32),
             [rng.randn(2, 1, 4, 4).astype(np.float32), rng.randn(2, 1, 4, 4).astype(np.float32)]]
    port, ref = MultiScaleGANLoss('lsgan', loss_weight=0.5), jax_gan.MultiScaleGANLoss(
        'lsgan', loss_weight=0.5)
    for is_disc in (True, False):
        got = port([torch.from_numpy(preds[0]), [torch.from_numpy(p) for p in preds[1]]], False,
                   is_disc)
        want = ref([jnp.asarray(preds[0]), [jnp.asarray(p) for p in preds[1]]], False, is_disc)
        assert got.item() == pytest.approx(float(want), rel=TOL)
    assert port(torch.from_numpy(preds[0]), True).item() == pytest.approx(
        float(ref(jnp.asarray(preds[0]), True)), rel=TOL)


# ------------------------------------------------------------ VGG, perceptual
@pytest.mark.parametrize('variant', ['default', 'range_norm', 'no_pooling', 'no_input_norm'])
def test_vgg_feature_extractor_matches_jax(variant, vgg_path):
    """Layers down to ``conv5_4`` at 32x32, both packages reading the same
    ``.pth``: with the input norm, after ``range_norm``, without the pools
    (then ``conv5_4`` at full size) and without the input norm."""
    layers = ['conv1_2', 'relu2_1', 'pool3', 'conv5_4'] if variant != 'no_pooling' \
        else ['conv1_2', 'conv3_1']
    opts = dict(range_norm=variant == 'range_norm', remove_pooling=variant == 'no_pooling',
                use_input_norm=variant != 'no_input_norm')
    x = np.random.RandomState(3).uniform(-1 if opts['range_norm'] else 0, 1,
                                         (2, 32, 32, 3)).astype(np.float32)
    jext = jax_vgg.VGGFeatureExtractor(layer_name_list=tuple(layers), **opts)
    params = jax_vgg.load_vgg_params(jext, pretrain_path=vgg_path)
    want = jax.jit(lambda p, v: jext.apply({'params': p}, v))(params, jnp.asarray(x))
    ext = VGGFeatureExtractor(layers, pretrain_path=vgg_path, **opts)
    assert not any(p.requires_grad for p in ext.parameters()) and not ext.vgg_net.training
    with torch.no_grad():
        got = ext(nchw(x))
    assert sorted(got) == sorted(want) == sorted(layers)
    for name in layers:
        assert_close(nhwc(got[name]), want[name], name)
    assert float(np.abs(np.asarray(want[layers[-1]])).mean()) > 1e-2   # deep features not vanishing


def test_vgg_without_weights_warns_and_draws_from_a_seed(tmp_path):
    """No file: a warning, and the same seed-0 weights every time."""
    from basicsr4rs_torch.archs import vgg_arch
    missing = str(tmp_path / 'absent.pth')
    with mock.patch.object(vgg_arch, 'get_root_logger') as logger:
        a = VGGFeatureExtractor(['conv1_1'], pretrain_path=missing)
        b = VGGFeatureExtractor(['conv1_1'], pretrain_path=missing)
    assert torch.equal(a.vgg_net.conv1_1.weight, b.vgg_net.conv1_1.weight)
    assert logger.return_value.warning.call_count == 2
    assert 'not found' in logger.return_value.warning.call_args[0][0]


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
@pytest.mark.parametrize('style', [0., 0.7])
def test_perceptual_loss_matches_jax(criterion, style, vgg_path):
    """Two layers with their weights, each criterion, with and without the
    style term: both losses and the gradient in the output (the GT's
    features carry none)."""
    layer_weights = {'conv2_2': 0.5, 'conv3_4': 1.0}
    rng = np.random.RandomState(4)
    x, gt = (rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    kwargs = dict(layer_weights=layer_weights, perceptual_weight=0.8, style_weight=style,
                  criterion=criterion, pretrain_path=vgg_path)
    ref = jax_percep.PerceptualLoss(**kwargs)

    def total(v, g):
        p, s = ref(v, g)
        return p + (s if s is not None else 0.), (p, s)

    (_, (want_p, want_s)), (want_gx, want_gg) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(gt))
    loss = PerceptualLoss(**kwargs)
    tx, tg = nchw(x).requires_grad_(), nchw(gt).requires_grad_()
    got_p, got_s = loss(tx, tg)
    (got_p + (got_s if got_s is not None else 0.)).backward()
    assert got_p.item() == pytest.approx(float(want_p), rel=TOL)
    assert (got_s is None) == (want_s is None) == (style == 0.)
    if style:
        assert got_s.item() == pytest.approx(float(want_s), rel=TOL)
    assert_close(nhwc(tx.grad), want_gx, 'd x', GRAD_TOL)
    assert tg.grad is None and not np.asarray(want_gg).any()


def test_gram_matches_jax():
    f = np.random.RandomState(5).randn(2, 5, 7, 6).astype(np.float32)
    assert_close(gram(nchw(f)).numpy(), jax_percep._gram(jnp.asarray(f)), 'gram')


# ------------------------------------------------------------- discriminators
@pytest.mark.parametrize('shape', [(8, 4, 4, 4), (64, 4, 1, 1), (6, 6, 3, 3)])
def test_spectral_normalize_matches_jax(shape):
    """Exact sigma on the small side's Gram matrix (out < in k k, out > in k
    k, square), value and gradient; the result's top singular value is 1."""
    rng = np.random.RandomState(6)
    w = rng.randn(*shape).astype(np.float32)
    c = rng.randn(*shape).astype(np.float32)
    hwio = lambda a: jnp.asarray(a.transpose(2, 3, 1, 0))  # noqa: E731
    want, want_grad = jax.value_and_grad(
        lambda v: jnp.sum(jax_disc.spectral_normalize(v) * hwio(c)))(hwio(w))
    tw = torch.from_numpy(w).requires_grad_()
    normed = port_disc.spectral_normalize(tw)
    (normed * torch.from_numpy(c)).sum().backward()
    assert_close((normed.detach() * torch.from_numpy(c)).sum().numpy(), want, 'value')
    assert_close(tw.grad.numpy().transpose(2, 3, 1, 0), want_grad, 'gradient', GRAD_TOL)
    assert torch.linalg.matrix_norm(normed.detach().reshape(shape[0], -1), 2).item() == \
        pytest.approx(1., rel=1e-5)


def test_unet_discriminator_matches_jax():
    """U-Net discriminator at 8 features on 32x32: three SN convs down, three
    bilinear x2 ups (the JAX ``resize_bilinear``) with skips; a checkpoint's
    ``weight_u`` and ``weight_v`` are dropped on load."""
    net = port_disc.UNetDiscriminatorSN(num_feat=8)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p[0].numel()**-0.5 if p.dim() > 1
                                                             else 0.1))
    sd = net.state_dict()
    params = convert_torch_state_dict(sd)
    x = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jax_disc.UNetDiscriminatorSN(num_feat=8).apply({'params': p}, v))(
        params, jnp.asarray(x))
    sd = dict(sd, **{'conv1.weight_u': torch.ones(16), 'conv1.weight_v': torch.ones(128)})
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(nchw(x))
    assert got.shape == (2, 1, 32, 32)
    assert_close(nhwc(got), want, 'UNetDiscriminatorSN')


def vgg_style_pair(seed=8):
    net = port_disc.VGGStyleDiscriminator(num_feat=8)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith('running_var'):
                t.uniform_(0.5, 2, generator=gen)
            elif not name.endswith('num_batches_tracked'):
                t.normal_(0, t[0].numel()**-0.5 if t.dim() > 1 else 0.1, generator=gen)
    sd = {k: v for k, v in net.state_dict().items() if not k.endswith('num_batches_tracked')}
    tree = convert_torch_state_dict(sd, jax_disc.VGGStyleDiscriminator.TORCH_KEY_RULES)
    stats = {k: {'mean': v.pop('running_mean'), 'var': v.pop('running_var')}
             for k, v in tree.items() if 'running_mean' in v}
    return net, tree, stats


def test_vgg_style_discriminator_train_mode_keeps_biased_running_variance():
    """Train mode on a batch of 4 at 128x128: the output, and the running
    statistics after the update equal Flax's (momentum 0.9, the batch's
    biased variance), which at the 4x4 stage lies 64/63 off the unbiased one
    that ``nn.BatchNorm2d`` would keep. In eval mode the running statistics
    serve."""
    net, params, stats = vgg_style_pair()
    # the last stage's running variance from 0, so that the update shows alone
    net.bn4_1.running_var.zero_()
    stats['bn4_1']['var'] = np.zeros_like(stats['bn4_1']['var'])
    x = np.random.RandomState(8).rand(4, 128, 128, 3).astype(np.float32)
    module = jax_disc.VGGStyleDiscriminator(num_feat=8)
    want, updates = module.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x),
                                 train=True, mutable=['batch_stats'])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    feats = {}
    net.bn4_1.register_forward_hook(lambda m, inp, out: feats.update(bn4_1=inp[0]))
    net.train()
    got = net(nchw(x))
    # each BatchNorm normalises by the statistics of the batch, at the last
    # stages of 64 values a channel: float32 noise grows to about 1e-5 there
    assert_close(got.detach().numpy(), want, 'train-mode output', GRAD_TOL)
    for bn, leaves in updates['batch_stats'].items():
        for leaf, value in leaves.items():
            assert_close(getattr(getattr(net, bn), f'running_{leaf}').numpy(), value,
                         f'{bn}.{leaf}')
        assert getattr(net, bn).num_batches_tracked.item() == before[
            f'{bn}.num_batches_tracked'].item() + 1
    feat = feats['bn4_1'].detach().double()   # 4 x 4 x 4 = 64 values a channel
    kept = net.bn4_1.running_var.double()
    assert torch.allclose(kept, 0.1 * feat.var(dim=(0, 2, 3), unbiased=False), rtol=1e-5, atol=0)
    assert torch.allclose(0.1 * feat.var(dim=(0, 2, 3), unbiased=True) / kept,
                          torch.full_like(kept, 64 / 63), rtol=1e-5)
    net.eval()
    with torch.no_grad():
        got = net(nchw(x))
    want = module.apply({'params': params, 'batch_stats': updates['batch_stats']},
                        jnp.asarray(x), train=False)
    assert_close(got.numpy(), want, 'eval-mode output')


def test_frozen_batch_stats_keeps_the_running_statistics():
    """Inside ``frozen_batch_stats`` a train-mode pass normalises by the
    batch (the same output as outside) and keeps every buffer; outside it
    updates them; the flag is restored on the way out."""
    net, _, _ = vgg_style_pair(9)
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with port_disc.frozen_batch_stats(net):
        frozen = net(x)
    for key, value in net.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert all(m.update_stats for m in net.modules() if isinstance(m, port_disc.BatchNorm2d))
    torch.testing.assert_close(net(x), frozen, rtol=0, atol=0)
    assert not torch.equal(net.bn0_1.running_mean, before['bn0_1.running_mean'])
    with pytest.raises(ValueError):
        net(torch.rand(1, 3, 64, 64))
