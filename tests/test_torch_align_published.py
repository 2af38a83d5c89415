"""Findings 1 and 2 of the published joint align-diffusion configs, in both
packages, on one network of the published image_size 64 at test width (the
JAX package's model is built once: its init and sampler take half a minute
to compile on the CPU): ``train_AlignResDiff_3loss_L2S_Square192.yml``
cannot train at its GT 192, and ``train_AlignResDiff_4loss_L2S_Square192.yml``'s
encoder loss raises."""

import copy

import numpy as np
import pytest

from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_tpu.losses.align_loss import EncoderLoss

from test_torch_align_findings import both, config, shrunk
from test_torch_align_models import l2s_batch

THREE_LOSS = config('train', 'AlignResDiff', 'train_AlignResDiff_3loss_L2S_Square192.yml')
FOUR_LOSS = config('train', 'AlignResDiff', 'train_AlignResDiff_4loss_L2S_Square192.yml')


@pytest.fixture(scope='module')
def three_loss():
    """The two packages' models of the 3-loss file."""
    return both(shrunk(THREE_LOSS))


def test_joint_model_at_the_published_gt_192_fails_in_both_packages(three_loss):
    """Finding 1: with image_size 64 the step crops both latents to 64x64,
    decodes them to 66x66, and the centre crop to the 192x192 GT starts at
    -63 and keeps 63x63: the losses raise, and test() answers 63x63."""
    port, jax_model = three_loss
    jax_batch, port_batch = l2s_batch(3, b=1, lq=64)
    port.feed_data(port_batch)
    jax_model.feed_data(jax_batch)
    with pytest.raises(RuntimeError, match='must match the size'):
        port.optimize_parameters(1)
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax_model.optimize_parameters(1)
    port.test()
    jax_model.test()
    assert port.output.shape == (1, 6, 63, 63)
    assert np.asarray(jax_model.output).shape == (1, 63, 63, 6)


def test_joint_model_with_the_encoder_loss_on_lq_fails_in_both_packages(three_loss):
    """Finding 2: the 4-loss file (the 3-loss file and ``encoder_opt:
    {type: EncoderLoss, strategy: lq}``) calls the encoder loss without the
    LQ, and raises, at GT 66 where the other losses run. The JAX model is
    the 3-loss one given the 4-loss file's encoder loss, which its step
    reads when it traces."""
    opt = shrunk(FOUR_LOSS)
    encoder_opt = dict(opt['train']['encoder_opt'])
    assert encoder_opt.pop('type') == 'EncoderLoss' and encoder_opt['strategy'] == 'lq'
    assert {k: v for k, v in opt['train'].items() if k != 'encoder_opt'} == \
        shrunk(THREE_LOSS)['train']
    port = port_build_model(copy.deepcopy(opt))
    _, jax_model = three_loss
    jax_batch, port_batch = l2s_batch(4, b=1, lq=22)
    port.feed_data(port_batch)
    jax_model.feed_data(jax_batch)
    jax_model.align_loss = EncoderLoss(**encoder_opt)
    try:
        for model in (port, jax_model):
            with pytest.raises(ValueError, match='requires the lq argument'):
                model.optimize_parameters(1)
    finally:
        jax_model.align_loss = None
    port.losses.pop('align')
    port.optimize_parameters(1)   # the other two, without it
    assert list(port.get_current_log()) == ['reconstruction', 'sr', 'loss']
