"""StyleGAN2Model: the non-saturating GAN with lazy regularisation
(counterpart of ``basicsr4rs_tpu/models/stylegan2_model.py``; reference:
basicsr/models/stylegan2_model.py).

The JAX package's step is the specification, where it differs from
BasicSR's:

* one Adam update a network a step. On a step whose number (the model's
  own count + 1) is a multiple of ``net_d_reg_every``, the gradient of the
  R1 penalty (weighted ``r1_reg_weight / 2 * net_d_reg_every``) is added
  to the discriminator's gradients before its one update; on a multiple
  of ``net_g_reg_every`` the path-length penalty's (weighted
  ``path_reg_weight * net_g_reg_every``) to the generator's. BasicSR steps
  each optimizer a second time instead;
* Adam at ``lr * ratio`` with betas ``(0 ** ratio, 0.99 ** ratio)``, ratio
  ``every / (every + 1)``, and a constant rate: the configured
  ``scheduler`` is not applied;
* the EMA generator moves every step with decay ``0.5 ** (32 / 10000)``;
* both phases draw two style codes, the second equal to the first where
  the step does not mix (``mixing_prob``); the path-length term runs on
  ``max(1, batch // path_batch_shrink)`` samples and keeps
  ``mean_path_length``.

Every random draw of a step comes from the model's ``torch.Generator``
(seeded by ``manual_seed`` plus the rank, saved with the training state),
through ``draw_step``. ``test`` samples the EMA generator on
``fixed_sample``; validation saves the first four samples side by side.

On several ranks both networks train data-parallel without DDP's wrapper
(``WRAP_IN_DDP = False``: R1 and the path length are double backwards, and
the discriminator has no gradient in the G phase). Both start from rank 0's
weights, and each network's gradients are averaged once before its one
update. ``batch`` is then the rank's rows, the global batch ``batch`` times
the rank count; the path batch follows the JAX package's global rule,
``max(1, global batch // path_batch_shrink)``, split over the ranks (the
first ``rows % ranks`` take one more), R1's and the path length's means,
and so ``mean_path_length``, are the global rows' (``gan_loss``), and so
are the discriminator's minibatch-stddev groups. Each rank draws its own
rows' codes and noise.
"""

from __future__ import annotations

from collections import OrderedDict
from os import path as osp

import numpy as np
import torch
from torch.profiler import record_function

from ..archs import build_network
from ..losses import build_loss
from ..losses.gan_loss import g_path_regularize, r1_penalty
from ..utils.dist_util import global_mean
from ..utils.img_util import imwrite, tensor2img
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


@MODEL_REGISTRY.register()
class StyleGAN2Model(BaseModel):

    WRAP_IN_DDP = False

    def __init__(self, opt):
        super().__init__(opt)
        self.net_g = build_network(opt['network_g']).to(self.device)
        self.print_network(self.net_g)
        self.num_style_feat = opt['network_g']['num_style_feat']
        path_opt = self.opt['path']
        if path_opt.get('pretrain_network_g') is not None:
            self.load_network(self.net_g, path_opt['pretrain_network_g'],
                              path_opt.get('strict_load_g', True),
                              path_opt.get('param_key_g', 'params'))
        self.net_g = self.model_to_device(self.net_g)
        seed = opt.get('manual_seed') or 0
        self.generator = torch.Generator(self.device).manual_seed(seed + opt.get('rank', 0))
        num_val_samples = (opt.get('val') or {}).get('num_val_samples', 16)
        self.fixed_sample = torch.randn((num_val_samples, self.num_style_feat),
                                        generator=torch.Generator().manual_seed(seed)).to(
                                            self.device)
        self.step = 0
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g.eval()
            self.net_g_ema = self.net_g

    # ------------------------------------------------------------- training
    def init_training_settings(self):
        train_opt = self.opt['train']
        path_opt = self.opt['path']
        self.net_d = build_network(self.opt['network_d']).to(self.device)
        self.print_network(self.net_d)
        if path_opt.get('pretrain_network_d') is not None:
            self.load_network(self.net_d, path_opt['pretrain_network_d'],
                              path_opt.get('strict_load_d', True),
                              path_opt.get('param_key_d', 'params'))
        self.net_d = self.model_to_device(self.net_d)
        self.net_g_ema = build_network(self.opt['network_g']).to(self.device)
        self.start_ema()
        self.net_g_ema.eval().requires_grad_(False)
        self.net_g.train()
        self.net_d.train()

        self.cri_gan = build_loss(train_opt['gan_opt']).to(self.device)
        self.r1_reg_weight = train_opt['r1_reg_weight']
        self.path_reg_weight = train_opt['path_reg_weight']
        self.net_g_reg_every = train_opt['net_g_reg_every']
        self.net_d_reg_every = train_opt['net_d_reg_every']
        self.mixing_prob = train_opt['mixing_prob']
        self.path_batch_shrink = train_opt.get('path_batch_shrink', 2)
        self.ema_decay = 0.5 ** (32 / (10 * 1000))
        self.mean_path_length = torch.zeros((), device=self.device)
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self):
        train_opt = self.opt['train']
        for label, net, every in (('g', self.net_g, self.net_g_reg_every),
                                  ('d', self.net_d, self.net_d_reg_every)):
            ratio = every / (every + 1)
            optim_opt = dict(train_opt[f'optim_{label}'])
            optimizer = self.get_optimizer(optim_opt['type'], net.parameters(),
                                           optim_opt['lr'] * ratio,
                                           betas=(0**ratio, 0.99**ratio))
            setattr(self, f'optimizer_{label}', optimizer)
            self.optimizers.append(optimizer)

    def setup_schedulers(self):
        """Constant rates: the JAX package's model applies no schedule."""
        for optimizer in self.optimizers:
            self.schedulers.append(torch.optim.lr_scheduler.LambdaLR(optimizer, lambda _: 1.))

    def _noise_maps(self, batch: int):
        net = self.net_g
        return [torch.randn((batch, 1) + getattr(net.noises, f'noise{i}').shape[2:],
                            generator=self.generator, device=self.device)
                for i in range(net.num_layers)]

    def _mixing_codes(self, batch: int):
        """Two codes; the second is the first unless the step mixes."""
        z1, z2 = torch.randn((2, batch, self.num_style_feat), generator=self.generator,
                             device=self.device)
        mix = torch.rand((), generator=self.generator, device=self.device) < self.mixing_prob
        return [z1, torch.where(mix, z2, z1)]

    def path_rows(self, batch: int) -> int:
        """This rank's rows of the path batch: ``max(1, global batch //
        path_batch_shrink)`` split over the ranks, the first ``rows %
        ranks`` taking one more (a rank may take none)."""
        world_size = self.opt.get('world_size', 1) if self.data_parallel() else 1
        total = max(1, batch * world_size // self.path_batch_shrink)
        return total // world_size + int(self.opt.get('rank', 0) < total % world_size)

    def draw_step(self, batch: int, regularize_g: bool):
        """The random draws of one step: the codes and noise maps of the D
        phase's and the G phase's fake batch and, on a path-length step,
        the path batch's codes and noise maps (this rank's ``path_rows``)
        and the noise its image is projected on."""
        draws = {'d_codes': self._mixing_codes(batch), 'd_noise': self._noise_maps(batch),
                 'g_codes': self._mixing_codes(batch), 'g_noise': self._noise_maps(batch)}
        if regularize_g:
            path_batch = self.path_rows(batch)
            size = 2**self.net_g.log_size
            draws.update(path_codes=self._mixing_codes(path_batch),
                         path_noise=self._noise_maps(path_batch),
                         path_proj=torch.randn((path_batch, 3, size, size),
                                               generator=self.generator, device=self.device))
        return draws

    def feed_data(self, data):
        self.real_img = data['gt'].to(self.device, non_blocking=True)

    def optimize_parameters(self, current_iter):
        step = self.step + 1
        regularize_d = step % self.net_d_reg_every == 0
        regularize_g = step % self.net_g_reg_every == 0
        draws = self.draw_step(self.real_img.shape[0], regularize_g)
        zero = torch.zeros((), device=self.device)

        with record_function('D phase'):
            self.net_d.requires_grad_(True)
            with torch.no_grad():
                fake_img, _ = self.net_g(draws['d_codes'], noise=draws['d_noise'])
            fake_pred = self.net_d(fake_img)
            real_pred = self.net_d(self.real_img)
            l_d = (self.cri_gan(real_pred, True, is_disc=True)
                   + self.cri_gan(fake_pred, False, is_disc=True))
            self.optimizer_d.zero_grad(set_to_none=True)
            l_d.backward()
            l_d_r1 = zero
            if regularize_d:   # its gradient joins the one update below
                l_d_r1 = r1_penalty(self.net_d, self.real_img)
                (self.r1_reg_weight / 2 * l_d_r1 * self.net_d_reg_every).backward()
            self.average_gradients(self.net_d)
            self.optimizer_d.step()

        with record_function('G phase'):
            self.net_d.requires_grad_(False)
            fake_img, _ = self.net_g(draws['g_codes'], noise=draws['g_noise'])
            l_g = self.cri_gan(self.net_d(fake_img), True, is_disc=False)
            self.optimizer_g.zero_grad(set_to_none=True)
            l_g.backward()
            l_g_path, path_length = zero, zero
            if regularize_g:
                codes = draws['path_codes']
                latents = (self.net_g.latents(codes) if len(codes[0]) else codes[0].new_zeros(
                    (0, self.net_g.num_latent, self.num_style_feat)))

                def fake_from_latent(w):
                    return self.net_g(w, input_is_latent=True, noise=draws['path_noise'])[0]

                l_path, path_lengths, self.mean_path_length = g_path_regularize(
                    fake_from_latent, latents, self.mean_path_length, draws['path_proj'])
                l_g_path = self.path_reg_weight * self.net_g_reg_every * l_path
                l_g_path.backward()
                path_length = global_mean(path_lengths)
            self.average_gradients(self.net_g)
            self.optimizer_g.step()
            self.model_ema(decay=self.ema_decay)
        self.step = step
        self.log_dict = self.reduce_loss_dict(OrderedDict(
            l_d=l_d, real_score=real_pred.detach().mean(), fake_score=fake_pred.detach().mean(),
            l_d_r1=l_d_r1, l_g=l_g, l_g_path=l_g_path, path_length=path_length))

    def current_step(self) -> int:
        return self.step

    # ----------------------------------------------------------------- eval
    def test(self):
        """The EMA generator's samples of ``fixed_sample``, with noise from
        a generator seeded 0 (the same samples every time)."""
        with torch.inference_mode():
            self.output, _ = self.net_g_ema([self.fixed_sample],
                                            generator=torch.Generator(self.device).manual_seed(0))

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        """Sample ``fixed_sample`` and save the first four side by side."""
        self.test()
        result = [tensor2img(img, min_max=(-1, 1)) for img in self.output.cpu()]
        grid = np.concatenate(result[:4], axis=1)
        if self.opt['is_train']:
            save_img_path = osp.join(self.opt['path']['visualization'], 'train',
                                     f'train_{current_iter}.png')
        else:
            save_img_path = osp.join(self.opt['path']['visualization'], 'test',
                                     f'test_{self.opt["name"]}.png')
        imwrite(grid, save_img_path)

    # ---------------------------------------------------------- save/resume
    def save(self, epoch, current_iter):
        self.save_network([self.net_g, self.net_g_ema], 'g', current_iter,
                          param_key=['params', 'params_ema'])
        self.save_network(self.net_d, 'd', current_iter)
        self.save_training_state(epoch, current_iter)

    def extra_training_state(self):
        return {'step': self.step, 'mean_path_length': self.mean_path_length.cpu(),
                'generator': self.generator.get_state()}

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        self.step = int(resume_state['step'])
        self.mean_path_length = resume_state['mean_path_length'].to(self.device)
        self.generator.set_state(resume_state['generator'])

