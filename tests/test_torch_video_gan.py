"""The port's video GAN models (``VideoRecurrentGANModel``,
``VideoGANModel`` in basicsr4rs_torch/models/video_recurrent_model.py)
against the JAX package's: one training step of ``VideoRecurrentGANModel``
from the same ``.pth`` files (BasicVSR at 8 features and 1 block,
``VGGStyleDiscriminator`` at 8 features on 256x256 frames, L1, a VGG
perceptual loss on a random VGG19, the vanilla GAN loss, EMA, SGD) on the
same 2-frame clip: the logged losses, the generator, its EMA and the
discriminator after the step: losses within 1e-5 relative, each tensor's
update within 1e-3 of the network's largest update (float32 gradients
through SpyNet's warps are the noisiest: per tensor they reach 1e-3 of the
tensor's own largest), plus 1e-6 of the tensor's scale.
The config asks for ``fix_flow`` and ``flow_lr_mul``, which neither
package's GAN step reads: SpyNet learns at the generator's rate from the
first step. Float32 on the CPU, ``num_gpu: 0``."""

import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.basicvsr_arch import BasicVSR
from basicsr4rs_torch.archs.discriminator_arch import VGGStyleDiscriminator
from basicsr4rs_torch.archs.edvr_arch import EDVR
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.video_recurrent_model import VideoGANModel, VideoRecurrentGANModel
from basicsr4rs_tpu.models import srgan_model as jax_srgan_model

from test_torch_basicvsr import few_threads  # noqa: F401 (autouse fixture)
from test_torch_esrgan import TOL, gan_opt, jax_state_dict
from test_torch_gan_losses import write_vgg19
from test_torch_video_models import jax_build_model

G_NET = dict(type='BasicVSR', num_feat=8, num_block=1)
D_NET = dict(type='VGGStyleDiscriminator', num_in_ch=3, num_feat=8, input_size=256)


def write_inputs(tmp, g):
    """Random G and D ``.pth`` files (the D's parameters only, as in
    ``test_torch_esrgan.py``) and a VGG19 to ``conv2_2``."""
    d = VGGStyleDiscriminator(num_feat=8, input_size=256)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            p.normal_(0, p[0].numel()**-0.5 if p.dim() > 1 else 0.1, generator=gen)
    torch.save({'params': g.state_dict()}, tmp / 'g.pth')
    torch.save({'params': dict(d.named_parameters())}, tmp / 'd.pth')
    write_vgg19(tmp / 'vgg.pth', convs=4)


def assert_params_close(port_sd, jax_sd, before, what):
    """Each tensor's update within 1e-3 of the network's largest update,
    plus 1e-6 of the tensor's scale."""
    keys = [k for k in port_sd if not k.endswith('num_batches_tracked')]
    biggest = max((jax_sd[k].double() - before[k].double()).abs().max().item() for k in keys)
    for key in keys:
        want = jax_sd[key].double()
        err = (port_sd[key].double() - want).abs().max().item()
        assert err <= 1e-3 * biggest + 1e-6 * want.abs().max().item(), f'{what} {key}: {err:.3e}'


def video_gan_opt(tmp, model_type, g_net, **train):
    opt = gan_opt(model_type, tmp, {'type': 'SGD', 'lr': 0.05}, **train)
    opt.update(network_g=dict(g_net), network_d=dict(D_NET))
    return opt


@pytest.fixture(scope='module')
def stepped(tmp_path_factory):
    """Both packages' models after one step from the same files and batch:
    (port model, JAX model, G's and D's state before the step)."""
    tmp = tmp_path_factory.mktemp('video_gan')
    torch.manual_seed(0)
    write_inputs(tmp, BasicVSR(**{k: v for k, v in G_NET.items() if k != 'type'}))
    opt = video_gan_opt(tmp, 'VideoRecurrentGANModel', G_NET, fix_flow=3, flow_lr_mul=0.125)
    port = port_build_model(copy.deepcopy(opt))
    with mock.patch.object(jax_srgan_model, 'jit_init', jax.jit):
        ref = jax_build_model(copy.deepcopy(opt))
    g_before = {k: v.clone() for k, v in port.net_g.state_dict().items()}
    d_before = {k: v.clone() for k, v in port.net_d.state_dict().items()}
    rng = np.random.RandomState(2)
    data = {'lq': rng.rand(1, 2, 3, 64, 64).astype(np.float32),
            'gt': rng.rand(1, 2, 3, 256, 256).astype(np.float32)}
    port.feed_data({k: torch.from_numpy(v) for k, v in data.items()})
    port.update_learning_rate(1)
    port.optimize_parameters(1)
    ref.feed_data({k: np.ascontiguousarray(np.moveaxis(v, 2, -1)) for k, v in data.items()})
    ref.optimize_parameters(1)
    return port, ref, g_before, d_before


def test_video_recurrent_gan_step_matches_jax(stepped):
    port, ref, g_before, d_before = stepped
    assert isinstance(port, VideoRecurrentGANModel)
    got, want = port.get_current_log(), ref.get_current_log()
    assert list(got) == list(want) == ['l_g_pix', 'l_g_percep', 'l_g_gan', 'l_g_total',
                                       'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake']
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=TOL, abs=1e-7), key
    assert_params_close(port.net_g.state_dict(), jax_state_dict(ref.state.params), g_before, 'G')
    assert_params_close(port.net_g_ema.state_dict(), jax_state_dict(ref.state.ema_params),
                        g_before, 'EMA')
    assert_params_close(port.net_d.state_dict(),
                        jax_state_dict(ref.d_state.params, VGGStyleDiscriminator.JAX_KEY_RULES,
                                       ref.d_state.stats), d_before, 'D')


def test_spynet_learns_at_the_generator_rate(stepped):
    """No param group of its own, and a move in step 1 (``fix_flow`` is 3)
    by plain SGD at the generator's rate (to the rounding of the weight:
    2 ** -23 of its largest entry)."""
    port, _, g_before, _ = stepped
    assert len(port.optimizer_g.param_groups) == 1
    key = 'spynet.basic_module.0.basic_module.0.weight'
    step = port.net_g.state_dict()[key] - g_before[key]
    assert step.abs().max() > 0
    grad = port.net_g.get_parameter(key).grad
    torch.testing.assert_close(step, -0.05 * grad, rtol=1e-5,
                               atol=2.**-23 * g_before[key].abs().max().item())


def test_video_gan_model_trains_on_windows(tmp_path):
    """``VideoGANModel`` over an EDVR generator: the discriminator sees the
    centre frame's output, and one step moves both networks."""
    g_net = dict(type='EDVR', num_feat=8, num_frame=3, deformable_groups=2, num_extract_block=1,
                 num_reconstruct_block=1)
    torch.manual_seed(0)
    write_inputs(tmp_path, EDVR(**{k: v for k, v in g_net.items() if k != 'type'}))
    model = port_build_model(video_gan_opt(tmp_path, 'VideoGANModel', g_net))
    assert isinstance(model, VideoGANModel)
    g_before = [p.detach().clone() for p in model.net_g.parameters()]
    d_before = [p.detach().clone() for p in model.net_d.parameters()]
    model.feed_data({'lq': torch.rand(1, 3, 3, 64, 64), 'gt': torch.rand(1, 3, 256, 256)})
    model.optimize_parameters(1)
    logs = model.get_current_log()
    assert all(np.isfinite(v) for v in logs.values())
    assert any(not torch.equal(p, b) for p, b in zip(model.net_g.parameters(), g_before))
    assert any(not torch.equal(p, b) for p, b in zip(model.net_d.parameters(), d_before))
