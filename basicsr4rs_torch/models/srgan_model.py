"""SRGANModel, GAN training of an SR generator (counterpart of
``basicsr4rs_tpu/models/srgan_model.py``; reference:
basicsr/models/srgan_model.py).

On top of ``SRModel``: the discriminator ``network_d`` (``pretrain_network_d``
loads into it), its own optimizer and scheduler, and a step in two phases.

* G phase: the generator's losses (pixel, LDL, perceptual and style, GAN)
  with the discriminator as it stands. Its passes run in train mode but
  keep the BatchNorm running statistics as they are
  (``frozen_batch_stats``), as the JAX package throws their update away.
  The update is gated: at ``current_iter % net_d_iters != 0`` or
  ``current_iter <= net_d_init_iters`` the optimizer does not step, so its
  moments and step count stay as they are, while the schedulers go on. The
  EMA moves on every step, gated or not, after the update.
* D phase: the real batch (the GAN target of ``loss_targets()``), then the
  generator's output detached; each pass updates the running statistics,
  the second from the first's.

On several ranks both networks train data-parallel without DDP's wrapper
(``WRAP_IN_DDP = False``): the discriminator has no gradient in the G
phase and the G update is gated, which DDP's reducer does not fit. Both
start from rank 0's weights and BatchNorm buffers, each phase averages its
network's gradients once before its optimizer steps (a gated G step
exchanges and applies nothing, on every rank alike), and the BatchNorm
passes take the global batch's statistics (``sync_ranks``), so that the
buffers stay the same on every rank.

``train.ldl_opt`` adds LDL's artifact-weighted pixel loss (against the EMA
network's output, so it needs ``ema_decay`` > 0). ``save`` writes
``net_g_<iter>.pth`` (``params``, ``params_ema``) and ``net_d_<iter>.pth``;
the ``.state`` file holds both optimizers, both schedulers and the
discriminator's BatchNorm buffers, which ``resume_training`` restores.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict

import torch
from torch.profiler import record_function

from ..archs import build_network
from ..archs.arch_util import frozen_batch_stats
from ..losses import build_loss
from ..losses.loss_util import get_refined_artifact_map
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):

    WRAP_IN_DDP = False

    def init_training_settings(self):
        train_opt = self.opt['train']
        self.net_g.train()
        self._init_ema()

        self.net_d = build_network(self.opt['network_d']).to(self.device)
        self.print_network(self.net_d)
        load_path = self.opt['path'].get('pretrain_network_d')
        if load_path is not None:
            self.load_network(self.net_d, load_path, self.opt['path'].get('strict_load_d', True),
                              self.opt['path'].get('param_key_d', 'params'))
        self.net_d = self.model_to_device(self.net_d)
        self.net_d.train()

        self.build_pixel_and_perceptual_losses()
        self.cri_ldl = (build_loss(train_opt['ldl_opt']).to(self.device)
                        if train_opt.get('ldl_opt') else None)
        if self.cri_ldl is not None and self.ema_decay <= 0:
            raise ValueError('ldl_opt requires ema_decay > 0.')   # the map needs net_g_ema
        self.cri_gan = build_loss(train_opt['gan_opt']).to(self.device)
        self.net_d_iters = train_opt.get('net_d_iters', 1)
        self.net_d_init_iters = train_opt.get('net_d_init_iters', 0)

        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self):
        super().setup_optimizers()
        optim_opt = dict(self.opt['train']['optim_d'])
        self.optimizer_d = self.get_optimizer(optim_opt.pop('type'), self.net_d.parameters(),
                                              **optim_opt)
        self.optimizers.append(self.optimizer_d)

    def update_learning_rate(self, current_iter: int, warmup_iter: int = -1):
        # while the generator's steps are gated its optimizer has not stepped,
        # and its schedule goes on all the same, which torch warns about
        with warnings.catch_warnings():
            warnings.filterwarnings('ignore', message=r'Detected call of `lr_scheduler\.step\(\)`')
            super().update_learning_rate(current_iter, warmup_iter)

    # ------------------------------------------------------------- G phase
    def _g_gan_loss(self, output):
        """The generator's GAN loss (ESRGAN overrides it)."""
        return self.cri_gan(self.net_d(output), True, is_disc=False)

    def _ldl_loss(self, output):
        """LDL: the pixel loss weighted by the artifact map of the output
        against the EMA network's output."""
        with torch.no_grad():
            output_ema = self.net_g_ema(self.lq)
        pixel_weight = get_refined_artifact_map(self.gt, output, output_ema, 7)
        return self.cri_ldl(pixel_weight * output, pixel_weight * self.gt)

    def _g_losses(self, output):
        """(total, losses): pixel, LDL, perceptual and style, GAN; the first
        and the perceptual terms against ``loss_targets()``, LDL's against
        the GT batch."""
        losses = OrderedDict()
        pix_gt, percep_gt, _ = self.loss_targets()
        total = self.pixel_and_perceptual_losses(output, pix_gt, losses,
                                                 ('l_g_pix', 'l_g_percep', 'l_g_style'),
                                                 percep_target=percep_gt)
        if self.cri_ldl is not None:
            losses['l_g_ldl'] = self._ldl_loss(output)
            total = total + losses['l_g_ldl']
            for name in ('l_g_percep', 'l_g_style'):   # logged after LDL, as in the JAX package
                if name in losses:
                    losses.move_to_end(name)
        with frozen_batch_stats(self.net_d):
            losses['l_g_gan'] = self._g_gan_loss(output)
        total = total + losses['l_g_gan']
        losses['l_g_total'] = total
        return total, losses

    # ------------------------------------------------------------- D phase
    def _d_losses(self, real, fake):
        """(total, losses) of the discriminator on the real batch, then on
        the detached output."""
        real_d_pred = self.net_d(real)
        l_d_real = self.cri_gan(real_d_pred, True, is_disc=True)
        fake_d_pred = self.net_d(fake)
        l_d_fake = self.cri_gan(fake_d_pred, False, is_disc=True)
        losses = OrderedDict(l_d_real=l_d_real, l_d_fake=l_d_fake,
                             out_d_real=real_d_pred.detach().mean(),
                             out_d_fake=fake_d_pred.detach().mean())
        return l_d_real + l_d_fake, losses

    def optimize_parameters(self, current_iter):
        # the two phases are profiler ranges: a trace splits the step's
        # device time between them
        with record_function('G phase'):
            for p in self.net_d.parameters():
                p.requires_grad_(False)
            self.optimizer_g.zero_grad(set_to_none=True)
            self.output = self.net_g(self.lq)
            l_g_total, loss_dict = self._g_losses(self.output)
            if current_iter % self.net_d_iters == 0 and current_iter > self.net_d_init_iters:
                l_g_total.backward()
                self.average_gradients(self.net_g)
                self.optimizer_g.step()
            if self.ema_decay > 0:
                self.model_ema(decay=self.ema_decay)

        with record_function('D phase'):
            for p in self.net_d.parameters():
                p.requires_grad_(True)
            self.optimizer_d.zero_grad(set_to_none=True)
            l_d_total, d_losses = self._d_losses(self.loss_targets()[2], self.output.detach())
            l_d_total.backward()
            self.average_gradients(self.net_d)
            self.optimizer_d.step()
        loss_dict.update(d_losses)
        self.log_dict = self.reduce_loss_dict(loss_dict)

    # ------------------------------------------------------------ checkpoints
    def save(self, epoch, current_iter):
        if self.ema_decay > 0:
            self.save_network([self.net_g, self.net_g_ema], 'g', current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(self.net_g, 'g', current_iter)
        self.save_network(self.net_d, 'd', current_iter)
        self.save_training_state(epoch, current_iter)

    def extra_training_state(self):
        state = super().extra_training_state()
        state['stats_d'] = OrderedDict((k, v.detach().cpu()) for k, v in
                                       self.net_d.named_buffers())
        return state

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        buffers = dict(self.net_d.named_buffers())
        with torch.no_grad():
            for name, value in resume_state.get('stats_d', {}).items():
                buffers[name].copy_(value)
