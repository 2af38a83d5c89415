"""ResShiftModel, latent residual-shifting diffusion SR (counterpart of
``basicsr4rs_tpu/models/resshift_model.py``; reference:
basicsr/models/resshift_model.py).

A frozen first-stage autoencoder (VQ or KL) defines the latent space; the
``UNetModelSwin`` denoiser is trained on one random timestep per sample
with the ResShift objective. ``test()`` runs the whole reverse chain on the
EMA weights and decodes. Images are in [-1, 1]. The model's own random
draws (timesteps, noise) come from one ``torch.Generator`` on the model's
device, seeded with ``manual_seed`` plus the rank (each rank draws for its
own rows) and saved with the training state. Under a launcher the UNet
trains wrapped in ``DistributedDataParallel``; the frozen first stage is not
wrapped (it has no trainable parameter).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..archs import build_network
from ..utils.gaussian_diffusion import create_gaussian_diffusion
from ..utils.registry import MODEL_REGISTRY
from .srrs_model import SRRSModel


@MODEL_REGISTRY.register()
class ResShiftModel(SRRSModel):

    def __init__(self, opt):
        super().__init__(opt)
        # the frozen first stage: no gradients, eval mode
        self.first_stage = None
        if 'autoencoder' in self.opt:
            self.first_stage = build_network(self.opt['autoencoder']).to(self.device)
            load_path = self.opt['path'].get('pretrain_network_ae')
            if load_path is not None:
                self.load_network(self.first_stage, load_path, True, 'params')
            self.first_stage.eval().requires_grad_(False)
        self.base_diffusion = create_gaussian_diffusion(**self.opt['diffusion'])
        self.cond_lq = self.opt['network_g'].get('cond_lq', True)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (self.opt.get('manual_seed') or 0) + self.opt.get('rank', 0))

    def init_training_settings(self):
        self.net_g.train()
        self._init_ema()
        self.cri_pix = None
        self.setup_optimizers()
        self.setup_schedulers()

    def feed_data(self, data):
        """``lq`` and ``gt``; a batch may also carry the step's timesteps
        ``tt`` (B,) and latent ``noise``, which are otherwise drawn."""
        super().feed_data(data)
        self.tt = data['tt'].to(self.device) if 'tt' in data else None
        self.noise = data['noise'].to(self.device) if 'noise' in data else None

    def _denoiser(self, net):
        """``model(x, t)`` over ``net`` with the fed LQ as its condition."""
        kwargs = {'lq': self.lq} if self.cond_lq else {}

        def model(x, t):
            with self.autocast():
                return net(x, t, **kwargs)
        return model

    def compute_losses(self):
        diffusion = self.base_diffusion
        steps = diffusion.num_timesteps
        tt = self.tt
        if tt is None:
            tt = torch.randint(0, steps, (self.gt.shape[0],), generator=self.generator,
                               device=self.generator.device).to(self.device)
        loss_dict, _, _ = diffusion.training_losses(
            self.generator, self._denoiser(self.net_g), self.gt, self.lq, tt,
            first_stage_model=self.first_stage, noise=self.noise)
        mse = loss_dict['mse']
        loss = mse.mean()
        logs = OrderedDict(loss=loss, mse=loss)
        # the loss at the first, the middle and the last timestep
        for step_mark in (1, steps // 2 + 1, steps):
            at_step = (tt == step_mark - 1).float()
            logs[f'mse{step_mark}'] = (mse.detach() * at_step).sum() / (at_step.sum() + 1e-4)
        return loss, logs

    def test(self):
        """The whole reverse chain on the LQ fed, decoded to an image."""
        net = self._test_net()
        was_training = net.training
        net.eval()
        with torch.inference_mode():
            self.output = self.base_diffusion.p_sample_loop(
                self.generator, self.lq, self._denoiser(net),
                first_stage_model=self.first_stage).float()
        net.train(was_training)

    def extra_training_state(self):
        state = super().extra_training_state()
        state['noise_generator'] = self.generator.get_state()
        return state

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        if 'noise_generator' in resume_state:
            self.generator.set_state(resume_state['noise_generator'].cpu())
