"""SRModel (counterpart of ``basicsr4rs_tpu/models/sr_model.py``; reference:
basicsr/models/sr_model.py).

Builds ``network_g`` on the model's device and loads ``pretrain_network_g``.
Training: pixel loss, one optimizer with its scheduler, an EMA copy of the
network (``net_g_ema``) that validation and the saved ``params_ema`` use.
Validation: each item of the loader is one request, run forward under
``torch.inference_mode()``, scored with the configured metrics and saved;
a metric whose type ends in ``_pt`` or ``_jax`` (``calculate_psnr_pt``) is
computed on the device from the output and the GT tensors, the others on
the host from their 8-bit images.
``val.quant_int8: true | 'static'`` runs the evaluation forward as W8A8
(``ops/quant.py``): dynamic activation scales, or scales calibrated on the
first evaluation batch and static from then on.
``val.selfensemble_testing`` averages the x8 flip / transpose ensemble.
Training losses: ``pixel_opt`` and ``perceptual_opt`` (a VGG feature loss
and its style term), either or both.
Under a launcher ``net_g`` trains wrapped in ``DistributedDataParallel``;
everything else (the EMA, evaluation, DropPath's generator, parameter names)
reads the bare network, and on several ranks validation runs on rank 0 while
the others wait (the JAX package's ``dist_validation``).
Under ``parallel: {spatial: N > 1}`` (``BaseModel.grid``) each rank trains on
its band of the batch's rows (``feed_data``, the JAX ``feed_data``'s
``batch_spec``), the network runs in the model's ``spatial_scope`` and its
gradients are averaged over every rank; DropPath draws by data rank, so the
ranks of a spatial group drop the same paths. The losses must have a spatial
route (the pixel losses with ``reduction: mean``). Validation strides the
images over the data ranks; each spatial group shares an image, on bands
(gathered by ``gather_rows`` before the metrics) when its padded height
divides into bands of whole ``band_rows_multiple()`` rows, else whole on
every rank of the group, as the JAX call sites give way to XLA; one sum
over the ranks merges the metrics.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from os import path as osp

import numpy as np
import torch

from ..archs import build_network
from ..data import default_collate
from ..losses import build_loss
from ..metrics import calculate_metric
from ..ops.dcn import DCNv2Pack
from ..ops.quant import calibrate_act_scales, quantized_inference
from ..parallel import gather_rows, require_spatial_route, shard_batch
from ..parallel.halo import band_of
from ..utils.dist_util import barrier, sum_across_processes
from ..utils.img_util import imwrite, tensor2img
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


def _flips(x):
    """[identity, hflip, vflip, hvflip] of NCHW."""
    return [x, x.flip(3), x.flip(2), x.flip(2, 3)]


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    SPATIAL_SHARDING = True

    def __init__(self, opt):
        super().__init__(opt)
        self._quant_scales = None
        self.net_g = build_network(opt['network_g']).to(self.device)
        self.print_network(self.net_g)
        load_path = self.opt['path'].get('pretrain_network_g')
        if load_path is not None:
            self.load_network(self.net_g, load_path, self.opt['path'].get('strict_load_g', True),
                              self.opt['path'].get('param_key_g', 'params'))
        self.net_g = self.model_to_device(self.net_g)
        self.ema_decay = 0
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g.eval()

    # ----------------------------------------------------------- training
    def init_training_settings(self):
        self.net_g.train()
        train_opt = self.opt['train']
        net_g = self.get_bare_model(self.net_g)
        # the network's own random draws (DropPath) come from one generator,
        # seeded from the experiment's seed (plus the data rank: each data
        # rank drops its own rows' paths, the bands of a row the same) and
        # saved with the training state
        if hasattr(net_g, 'seed_drop_path'):
            net_g.seed_drop_path((self.opt.get('manual_seed') or 0) + self.grid.data_rank,
                                 self.device)

        self._init_ema()

        self.build_pixel_and_perceptual_losses()
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')

        if train_opt.get('log_dcn_offset'):
            for module in net_g.modules():
                if isinstance(module, DCNv2Pack):
                    module.log_offset = True

        self.setup_optimizers()
        self.setup_schedulers()

    def build_pixel_and_perceptual_losses(self):
        """``cri_pix`` and ``cri_perceptual`` from ``train.pixel_opt`` and
        ``train.perceptual_opt``, each None when the config leaves it out."""
        train_opt = self.opt['train']
        self.cri_pix = (build_loss(train_opt['pixel_opt']).to(self.device)
                        if train_opt.get('pixel_opt') else None)
        self.cri_perceptual = (build_loss(train_opt['perceptual_opt']).to(self.device)
                               if train_opt.get('perceptual_opt') else None)
        if self.grid.spatial > 1:
            require_spatial_route([c for c in (self.cri_pix, self.cri_perceptual)
                                   if c is not None], 'loss')

    def _init_ema(self):
        """``net_g_ema``, when ``train.ema_decay`` > 0: a second network, used
        only for testing and saving (``BaseModel.start_ema``)."""
        self.ema_decay = self.opt['train'].get('ema_decay', 0)
        if self.ema_decay > 0:
            get_root_logger().info(
                f'Use Exponential Moving Average with decay: {self.ema_decay}')
            self.net_g_ema = build_network(self.opt['network_g']).to(self.device)
            self.start_ema()
            self.net_g_ema.eval()

    def lr_multiplier(self, name: str) -> float:
        """The factor on the learning rate of the parameter ``name`` (the
        video models scale their alignment or flow parameters)."""
        return 1.

    def frozen_parameters(self, current_iter: int):
        """The parameters whose update iteration ``current_iter`` discards (a
        warm-up that trains a part of the network only)."""
        return []

    def setup_optimizers(self):
        """One optimizer; parameters with a learning-rate multiplier form a
        param group of their own with ``lr * multiplier``, which the
        schedulers and the warm-up scale like the first."""
        optim_opt = dict(self.opt['train']['optim_g'])
        groups = {}
        for name, param in self.get_bare_model(self.net_g).named_parameters():
            if param.requires_grad:
                groups.setdefault(self.lr_multiplier(name), []).append(param)
            else:
                get_root_logger().warning(f'Params {name} will not be optimized.')
        optim_params = groups.pop(1., [])
        if groups:
            optim_params = [{'params': optim_params}] + [
                {'params': params, 'lr': optim_opt['lr'] * mul} for mul, params in groups.items()]
        self.optimizer_g = self.get_optimizer(optim_opt.pop('type'), optim_params, **optim_opt)
        self.optimizers.append(self.optimizer_g)

    def feed_data(self, data):
        """The batch on the device; under ``spatial > 1`` this rank's band
        of its rows."""
        self._feed(data, bands=self.grid.spatial > 1)

    def _feed(self, data, bands):
        batch = shard_batch({k: data[k] for k in ('lq', 'gt') if k in data}, self.device,
                            spatial_sharded=bands, grid=self.grid)
        self.lq = batch['lq']
        if 'gt' in batch:
            self.gt = batch['gt']

    def loss_targets(self):
        """(pixel, perceptual, GAN) targets of the training losses: the GT
        batch for each (Real-ESRGAN's models pick its USM-sharpened copy
        term by term)."""
        return self.gt, self.gt, self.gt

    def pixel_and_perceptual_losses(self, output, target, loss_dict, names=('l_pix', 'l_percep',
                                                                              'l_style'),
                                    percep_target=None):
        """The sum of the pixel loss, the perceptual loss and its style term
        that the config asks for, of ``output`` against ``target`` (the
        perceptual terms against ``percep_target`` when given); each term
        goes into ``loss_dict`` under its name in ``names``."""
        terms = []
        if self.cri_pix is not None:
            terms.append((names[0], self.cri_pix(output, target)))
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(
                output, target if percep_target is None else percep_target)
            terms += [(name, value) for name, value in zip(names[1:], (l_percep, l_style))
                      if value is not None]
        loss_dict.update(terms)
        return sum(value for _, value in terms)

    def optimize_parameters(self, current_iter):
        self.optimizer_g.zero_grad(set_to_none=True)
        with self.spatial_scope():
            self.output = self.net_g(self.lq)
        loss_dict = OrderedDict()
        pix_gt, percep_gt, _ = self.loss_targets()
        self.pixel_and_perceptual_losses(self.output, pix_gt, loss_dict,
                                         percep_target=percep_gt).backward()
        self.average_gradients(self.net_g)
        # a frozen parameter takes part in the step (its moments and step
        # count run from the first iteration, as in the JAX package, which
        # masks the update) and gets its old value back
        frozen = self.frozen_parameters(current_iter)
        kept = [p.detach().clone() for p in frozen]
        self.optimizer_g.step()
        if frozen:
            with torch.no_grad():
                torch._foreach_copy_(frozen, kept)
        self.log_dict = self.reduce_loss_dict(loss_dict)
        if self.ema_decay > 0:
            self.model_ema(decay=self.ema_decay)

    def _test_net(self):
        """Validation uses the EMA network when training keeps one; never
        the data-parallel wrapper, whose forward would wait for the other
        ranks."""
        return self.net_g_ema if self.ema_decay > 0 else self.get_bare_model(self.net_g)

    def _quant_scope(self, net, x):
        """The W8A8 scope ``val.quant_int8`` asks for, or none. 'static'
        calibrates the activation scales on the first evaluation batch, in
        full precision, and keeps them; on a band (under the spatial scope)
        each scale is the whole map's (``ops/quant.py``)."""
        quant = (self.opt.get('val') or {}).get('quant_int8')
        if not quant:
            return contextlib.nullcontext()
        scales = None
        if quant == 'static':
            if self._quant_scales is None:
                self._quant_scales = calibrate_act_scales(net, net, [x])
            scales = self._quant_scales
        return quantized_inference(net, act_scales=scales)

    def band_rows_multiple(self) -> int:
        """Rows a band of an evaluation input must hold a whole number of
        (the network's window where it has one)."""
        return 1

    def _eval_on_bands(self, x) -> bool:
        """Whether an evaluation forward of the whole input x runs on this
        rank's band: under ``spatial > 1``, when x's rows split into bands
        of whole ``band_rows_multiple()`` rows."""
        shard = self.spatial_shard
        return shard is not None and x.shape[2] % (shard.size * self.band_rows_multiple()) == 0

    def _eval_forward(self, x):
        net = self._test_net()
        was_training = net.training
        net.eval()
        shard = self.spatial_shard if self._eval_on_bands(x) else None
        try:
            with torch.inference_mode(), (contextlib.nullcontext() if shard is None
                                          else self.spatial_scope()):
                x = band_of(x, shard)
                with self._quant_scope(net, x):
                    return gather_rows(net(x), shard)
        finally:
            net.train(was_training)

    def test(self):
        self.output = self._eval_forward(self.lq)

    def _test_views(self, views):
        """``test()`` on each view of the LQ (a subclass's padding and
        cropping included); the outputs, in order."""
        lq, outs = self.lq, []
        try:
            for view in views:
                self.lq = view
                self.test()
                outs.append(self.output)
        finally:
            self.lq = lq
        return outs

    def test_selfensemble(self):
        """x8 flip / transpose ensemble (reference sr_model.py:131-177): the
        four flips share a shape and so do the four transposed ones, so they
        run as two forwards of 4x the batch; ``val.selfensemble_batched:
        false`` runs the eight one at a time at a quarter of the memory."""
        lq = self.lq
        t = lq.transpose(2, 3)
        if (self.opt.get('val') or {}).get('selfensemble_batched', True):
            y, yt = (out.chunk(4, dim=0)
                     for out in self._test_views([torch.cat(_flips(lq)), torch.cat(_flips(t))]))
        else:
            outs = self._test_views(_flips(lq) + _flips(t))
            y, yt = outs[:4], outs[4:]
        # the flips are involutions: undo each with itself
        undo = [lambda v: v, lambda v: v.flip(3), lambda v: v.flip(2), lambda v: v.flip(2, 3)]
        outs = [f(v) for f, v in zip(undo, y)]
        outs += [f(v).transpose(2, 3) for f, v in zip(undo, yt)]
        self.output = torch.stack(outs).mean(dim=0)

    def save(self, epoch, current_iter):
        if self.ema_decay > 0:
            self.save_network([self.net_g, self.net_g_ema], 'g', current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(self.net_g, 'g', current_iter)
        self.save_training_state(epoch, current_iter)

    def extra_training_state(self):
        generator = getattr(self.get_bare_model(self.net_g), 'drop_path_generator', None)
        return {} if generator is None else {'drop_path_generator': generator.get_state()}

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        generator = getattr(self.get_bare_model(self.net_g), 'drop_path_generator', None)
        if generator is not None and 'drop_path_generator' in resume_state:
            generator.set_state(resume_state['drop_path_generator'].cpu())

    def get_current_visuals(self):
        out_dict = OrderedDict()
        out_dict['lq'] = self.lq.detach().cpu()
        out_dict['result'] = self.output.detach().cpu()
        if hasattr(self, 'gt'):
            out_dict['gt'] = self.gt.detach().cpu()
        return out_dict

    def dist_validation(self, dataloader, current_iter, tb_logger, save_img):
        """Rank 0 validates; the others wait for it, so that no collective
        of the next step times out behind a long validation. Under
        ``spatial > 1`` the data ranks stride the images, each spatial group
        runs its images together and its first rank records them; one sum
        over the ranks merges the metrics."""
        if self.grid.spatial > 1:
            dataset = dataloader.dataset
            grid = self.grid
            items = (default_collate([dataset[i]])
                     for i in range(grid.data_rank, len(dataset), grid.data))
            self._validate(items, dataset.opt['name'], current_iter, tb_logger, save_img,
                           record=grid.spatial_rank == 0, merge=True,
                           feed=lambda data: self._feed(data, bands=False))
            return
        if self.opt['rank'] == 0:
            self.nondist_validation(dataloader, current_iter, tb_logger, save_img)
        barrier()

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        self._validate(dataloader, dataloader.dataset.opt['name'], current_iter, tb_logger,
                       save_img)

    def _validate(self, items, dataset_name, current_iter, tb_logger, save_img, record=True,
                  merge=False, feed=None):
        """Each item: fed (by ``feed``, else ``feed_data``), forward, image,
        metrics (scored and saved only where ``record``); then the averages,
        from the sums of every rank when ``merge``."""
        val_opt = self.opt['val']
        with_metrics = val_opt.get('metrics') is not None
        if with_metrics:
            self.metric_results = {metric: 0 for metric in val_opt['metrics']}
            self._initialize_best_metric_results(dataset_name)

        cnt = 0
        for val_data in items:
            img_name = osp.splitext(osp.basename(val_data['lq_path'][0]))[0]
            (feed or self.feed_data)(val_data)
            if val_opt.get('selfensemble_testing', False):
                self.test_selfensemble()
            else:
                self.test()
            if not record:
                self.__dict__.pop('gt', None)
                continue

            visuals = self.get_current_visuals()
            metric_data = {'img': tensor2img(visuals['result'])}
            device_data = {'img': self.output}
            if 'gt' in visuals:
                metric_data['img2'] = tensor2img(visuals['gt'])
                device_data['img2'] = self.gt
                del self.gt

            if save_img:
                if self.is_train:
                    save_path = osp.join(self.opt['path']['visualization'], img_name,
                                         f'{img_name}_{current_iter}.png')
                else:
                    tag = val_opt.get('suffix') or self.opt['name']
                    save_path = osp.join(self.opt['path']['visualization'], dataset_name,
                                         f'{img_name}_{tag}.png')
                imwrite(metric_data['img'], save_path)

            if with_metrics:
                for name, opt_ in val_opt['metrics'].items():
                    # the device variants take the output and the GT where they are
                    on_device = str(opt_.get('type', '')).endswith(('_pt', '_jax'))
                    self.metric_results[name] += calculate_metric(
                        device_data if on_device else metric_data, opt_)
            cnt += 1

        if with_metrics and merge:
            names = list(self.metric_results)
            sums = sum_across_processes(np.array([float(self.metric_results[m]) for m in names]
                                                 + [cnt], np.float64))
            self.metric_results, cnt = dict(zip(names, sums[:-1].tolist())), int(sums[-1])
        if with_metrics and cnt > 0:
            for metric in self.metric_results:
                self.metric_results[metric] /= cnt
                self._update_best_metric_result(dataset_name, metric,
                                                self.metric_results[metric], current_iter)
            self._log_validation_metric_values(current_iter, dataset_name, tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name, tb_logger):
        log_str = f'Validation {dataset_name}\n'
        for metric, value in self.metric_results.items():
            log_str += f'\t # {metric}: {value:.4f}'
            record = self.best_metric_results[dataset_name][metric]
            log_str += f'\tBest: {record["val"]:.4f} @ {record["iter"]} iter\n'
        get_root_logger().info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f'metrics/{dataset_name}/{metric}', value, current_iter)
