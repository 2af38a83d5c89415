"""AlignSingleModel, which trains the align autoencoder on misregistered
L2S pairs (counterpart of ``basicsr4rs_tpu/models/align_single_model.py``;
reference: basicsr/models/align_single_model.py).

The network takes the registration input, the LQ enlarged x3 bicubically
beside the GT (12 bands). Stage 1 (the encoder's output) is held against the
enlarged LQ with ``stage1_opt``, stage 2 (the decoder's) against the GT with
``stage2_opt``; each first cropped about its centre to its target, since
every ``AlignNet`` grows the map by 2. ``test()`` answers stage 2, cropped."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..archs.arch_util import resize_bicubic
from ..losses import build_loss
from ..utils.registry import MODEL_REGISTRY
from .srrs_l2s_model import L2SSingleModel


def center_crop_to(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The (height, width) window about the centre of NCHW ``x``, by the JAX
    package's arithmetic: the start is half the difference, rounded down,
    and slices as Python's do, so that a smaller ``x`` gives a start below 0
    and a window cut short, not a padded one."""
    dh, dw = x.shape[-2] - height, x.shape[-1] - width
    if dh == 0 and dw == 0:
        return x
    t, l = dh // 2, dw // 2
    return x[..., t:t + height, l:l + width]


def registration_input(lq: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The LQ enlarged x3 bicubically, beside the GT."""
    return torch.cat([resize_bicubic(lq, 3.0), gt], dim=1)


@MODEL_REGISTRY.register()
class AlignSingleModel(L2SSingleModel):

    def init_training_settings(self):
        self.net_g.train()
        self._init_ema()
        train_opt = self.opt['train']
        if not (train_opt.get('stage1_opt') and train_opt.get('stage2_opt')):
            raise ValueError("Both 'stage1_opt' and 'stage2_opt' must be specified in the "
                             'training options.')
        self.stage1_loss = build_loss(train_opt['stage1_opt']).to(self.device)
        self.stage2_loss = build_loss(train_opt['stage2_opt']).to(self.device)
        self.cri_pix = None
        self.setup_optimizers()
        self.setup_schedulers()

    def feed_data(self, data):
        super().feed_data(data)
        if 'gt' in data:
            self.reg_input = registration_input(self.lq, self.gt)
            self.lq_up = self.reg_input[:, :self.lq.shape[1]]

    def compute_losses(self):
        with self.autocast():
            out = self.net_g(self.reg_input)
        stage1 = center_crop_to(out['stage1'].float(), *self.lq_up.shape[-2:])
        self.output = center_crop_to(out['stage2'].float(), *self.gt.shape[-2:])
        l1 = self.stage1_loss(stage1, self.lq_up)
        l2 = self.stage2_loss(self.output, self.gt)
        return l1 + l2, OrderedDict(stage1_loss=l1, stage2_loss=l2)

    def test(self):
        net = self._test_net()
        was_training = net.training
        net.eval()
        try:
            with torch.inference_mode(), self.autocast():
                stage2 = net(self.reg_input)['stage2']
        finally:
            net.train(was_training)
        self.output = center_crop_to(stage2.float(), *self.gt.shape[-2:])


# the published AlignAutoencoder configs name this trainer RegistrationModel
MODEL_REGISTRY.register(AlignSingleModel, 'RegistrationModel')
