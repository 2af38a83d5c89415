"""The align autoencoder, the LR encoder and the diffusion UNet trained
together (counterpart of ``basicsr4rs_tpu/models/align_joint_diff_model.py``;
reference: basicsr/models/align_joint_diff_model.py).

``network_g`` is a ``ResNetAE_SwinUNet``. A step encodes the registration
input (z_0) and the x3 LQ (z_lr), crops both about the centre to the
smaller of their sizes and the UNet's ``image_size``, and sums up to four
losses: ``encoder_opt`` (z_0 against the detached z_lr), ``diffusion_opt``
(the UNet's prediction of z_0, from q(z_t | detached z_0, detached z_lr)
conditioned on z_lr, against the detached z_0), ``decoder_opt`` (z_0
decoded, against the GT) and ``sr_opt`` (the prediction decoded, against
the GT); the decodings are cropped to the GT as ``AlignSingleModel``'s.
Gradients reach the autoencoder and the LR encoder through every path the
detachments leave. ``test()`` draws z_T about z_lr, runs the reverse steps
and decodes.

The step reaches the network through its methods (``apply_ae_encode``,
``apply_unet`` ...), never its ``forward``, which DDP's reducer needs to see:
on several ranks the network is not wrapped (``WRAP_IN_DDP = False``); it
starts from rank 0's weights and its gradients are averaged before each
step. Each rank draws its own rows' timesteps and noise."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..archs.arch_util import resize_bicubic
from ..losses import build_loss
from ..utils.gaussian_diffusion import _randn_like
from ..utils.registry import MODEL_REGISTRY
from .align_frozen_diff_model import AlignFrozenDiffModel
from .align_single_model import center_crop_to

_LOSSES = (('align', 'encoder_opt'), ('diffusion', 'diffusion_opt'),
           ('reconstruction', 'decoder_opt'), ('sr', 'sr_opt'))


@MODEL_REGISTRY.register()
class AlignJointDiffModel(AlignFrozenDiffModel):

    WRAP_IN_DDP = False

    def __init__(self, opt):
        super().__init__(opt)
        unet_args = self.opt['network_g']['unet_args']
        self.cond_lq = unet_args.get('cond_lq', True)
        self.image_size = unet_args.get('image_size')

    def init_training_settings(self):
        self.net_g.train()
        self._init_ema()
        train_opt = self.opt['train']
        self.losses = {name: build_loss(train_opt[key]).to(self.device)
                       for name, key in _LOSSES if train_opt.get(key)}
        self.cri_pix = None
        self.setup_optimizers()
        self.setup_schedulers()

    def _lr_latent(self, net, lq):
        with self.autocast():
            return net.apply_lr_encode(resize_bicubic(lq, float(self.base_diffusion.sf))).float()

    def _unet(self, net, z_lr):
        """``model(x, t)``: the UNet conditioned on ``z_lr``."""
        lq = z_lr if self.cond_lq else None

        def model(x, t):
            with self.autocast():
                return net.apply_unet(x, t, lq).float()
        return model

    def _decode(self, net, z):
        with self.autocast():
            return center_crop_to(net.apply_ae_decode(z).float(), *self.gt.shape[-2:])

    def compute_losses(self):
        net = self.net_g
        with self.autocast():
            z_0 = net.apply_ae_encode(self.reg_input).float()
        z_lr = self._lr_latent(net, self.lq)
        size = min(z_0.shape[-2], z_lr.shape[-2], self.image_size or z_0.shape[-2])
        z_0, z_lr = center_crop_to(z_0, size, size), center_crop_to(z_lr, size, size)
        z0_pred = self.base_diffusion.denoise_prediction(
            self.generator, self._unet(net, z_lr), z_0.detach(), z_lr.detach(),
            self._timesteps(), noise=self.noise)
        pairs = {'align': (z_0, z_lr.detach()), 'diffusion': (z0_pred, z_0.detach()),
                 'reconstruction': (self._decode(net, z_0), self.gt),
                 'sr': (self._decode(net, z0_pred), self.gt)}
        logs = OrderedDict((name, loss(*pairs[name])) for name, loss in self.losses.items())
        total = sum(logs.values())
        logs['loss'] = total
        return total, logs

    def test(self):
        net = self._test_net()
        was_training = net.training
        net.eval()
        try:
            with torch.inference_mode():
                z_lr = self._lr_latent(net, self.lq)
                if self.image_size and z_lr.shape[-2] > self.image_size:
                    z_lr = center_crop_to(z_lr, self.image_size, self.image_size)
                model, diffusion = self._unet(net, z_lr), self.base_diffusion
                z = diffusion.prior_sample(z_lr, _randn_like(z_lr, self.generator))
                for i in range(diffusion.num_timesteps - 1, -1, -1):
                    t = torch.full((z.shape[0],), i, dtype=torch.long, device=z.device)
                    z = diffusion.p_sample(self.generator, model, z, z_lr, t)['sample']
                with self.autocast():
                    out = net.apply_ae_decode(z).float()
        finally:
            net.train(was_training)
        self.output = center_crop_to(out, *self.gt.shape[-2:]) if hasattr(self, 'gt') else out
