"""SRRSModel, the remote-sensing SR base model (counterpart of
``basicsr4rs_tpu/models/srrs_model.py``; reference:
basicsr/models/srrs_model.py).

On top of ``SRModel``:

* a training step whose loss or gradients are not finite is skipped: the
  weights and the optimizer keep their state (the JAX package's
  ``optax.apply_if_finite`` with up to 100 consecutive skips);
* ``train.use_amp: true`` runs the network under
  ``torch.autocast(dtype=torch.bfloat16)``; bfloat16 needs no loss scaling;
* validation writes one CSV row of metrics per image, takes its images in
  the [-1, 1] convention, and saves the RGB bands and a NIR band as
  separate PNGs (``rswrite``).
"""

from __future__ import annotations

import csv
import os
from collections import OrderedDict
from os import path as osp

import cv2
import torch

from ..metrics import calculate_metric
from ..utils.img_util import imwrite, minusone_one_tensor_to_ubyte_numpy
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class SRRSModel(SRModel):

    MAX_CONSECUTIVE_SKIPS = 100

    def __init__(self, opt):
        self.use_amp = bool((opt.get('train') or {}).get('use_amp', False))
        self.consecutive_skips = 0   # non-finite steps in a row
        self.skipped_steps = 0       # non-finite steps in all
        super().__init__(opt)

    def autocast(self):
        """The context the network runs in: bfloat16 autocast under
        ``use_amp``, else nothing."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.use_amp)

    # ------------------------------------------------------------- training
    def compute_losses(self):
        """(the loss to differentiate, the losses to log) of the batch fed."""
        with self.autocast():
            self.output = self.net_g(self.lq)
        loss_dict = OrderedDict()
        return self.pixel_and_perceptual_losses(self.output.float(), self.gt, loss_dict), loss_dict

    def optimize_parameters(self, current_iter):
        self.optimizer_g.zero_grad(set_to_none=True)
        loss, loss_dict = self.compute_losses()
        loss.backward()
        self.average_gradients(self.net_g)
        self.step_if_finite(loss)
        self.log_dict = self.reduce_loss_dict(loss_dict)
        if self.ema_decay > 0:
            self.model_ema(decay=self.ema_decay)

    def step_if_finite(self, loss) -> bool:
        """``optimizer_g.step()`` unless the loss or a gradient is not finite;
        then the step is skipped, until ``MAX_CONSECUTIVE_SKIPS`` in a row
        have been. Reads one flag off the device. Returns whether it stepped."""
        grads = [p.grad for p in self.net_g.parameters() if p.grad is not None]
        finite = torch.isfinite(loss.detach())
        if grads:
            finite = finite & torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()
        finite = bool(finite)
        if finite:
            self.consecutive_skips = 0
        else:
            self.consecutive_skips += 1
            self.skipped_steps += 1
        if finite or self.consecutive_skips > self.MAX_CONSECUTIVE_SKIPS:
            self.optimizer_g.step()
            return True
        get_root_logger().warning('Non-finite loss or gradients: the optimizer step is skipped '
                                  f'({self.consecutive_skips} in a row).')
        return False

    # ----------------------------------------------------------- validation
    def _eval_forward(self, x):
        with self.autocast():
            return super()._eval_forward(x).float()

    def _extract_img_name(self, val_data: dict) -> str:
        lq_path = val_data['lq_path'][0]
        return (osp.basename(lq_path.split(',')[0]) if lq_path.endswith('.taco')
                else osp.splitext(osp.basename(lq_path))[0])

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        dataset_name = dataloader.dataset.opt['name']
        with_metrics = self.opt['val'].get('metrics') is not None
        if with_metrics:
            self.metric_results = {metric: 0 for metric in self.opt['val']['metrics']}
            self._initialize_best_metric_results(dataset_name)
        rows = OrderedDict()   # image name -> {metric: score}

        cnt = 0
        for val_data in dataloader:
            img_name = self._extract_img_name(val_data)
            self.feed_data(val_data)
            self.test()

            converted = {name: minusone_one_tensor_to_ubyte_numpy(tensor, rgb2bgr=False)
                         for name, tensor in self.get_current_visuals().items()
                         if tensor is not None}
            if hasattr(self, 'gt'):
                del self.gt
            if save_img:
                self._save_visuals(dataset_name, img_name, converted)
            if with_metrics and 'gt' in converted:
                metric_data = {'img': converted['result'], 'img2': converted['gt']}
                for name, opt_ in self.opt['val']['metrics'].items():
                    score = calculate_metric(metric_data, opt_)
                    rows.setdefault(img_name, {})[name] = score
                    self.metric_results[name] += score
            cnt += 1

        if with_metrics and cnt > 0:
            self._save_metrics_csv(dataset_name, current_iter, rows)
            for metric in self.metric_results:
                self.metric_results[metric] /= cnt
                self._update_best_metric_result(dataset_name, metric,
                                                self.metric_results[metric], current_iter)
            self._log_validation_metric_values(current_iter, dataset_name, tb_logger)

    def _save_visuals(self, dataset: str, img_name: str, images: dict):
        """The first three bands under ``RGB/``, a fourth under ``NIR/``."""
        vis_path = self.opt['path']['visualization']
        rgb = {name: img[..., :3] for name, img in images.items()}
        nir = {name: img[..., 3:4] for name, img in images.items()
               if img.ndim == 3 and img.shape[-1] > 3}
        self.rswrite(osp.join(vis_path, 'RGB', dataset, img_name), rgb, is_rgb_order=True)
        if nir:
            self.rswrite(osp.join(vis_path, 'NIR', dataset, img_name), nir, is_rgb_order=False)

    def _save_metrics_csv(self, dataset: str, iter_num, rows):
        """``<visualization>/<dataset>_<iter>.csv``: a header of the metric
        names after an empty first cell, then one row per image, the layout
        of ``pandas.DataFrame.to_csv``."""
        os.makedirs(self.opt['path']['visualization'], exist_ok=True)
        metrics = list(self.opt['val']['metrics'])
        path = osp.join(self.opt['path']['visualization'], f'{dataset}_{iter_num}.csv')
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow([''] + metrics)
            for img_name, scores in rows.items():
                writer.writerow([img_name] + [scores.get(m, '') for m in metrics])

    def rswrite(self, folder: str, images: dict, is_rgb_order: bool):
        """Write each image as ``<folder>/<key>.png`` unless it is there."""
        for key, value in images.items():
            save_file_path = osp.join(folder, f'{key}.png')
            if not osp.exists(save_file_path) and value is not None:
                img = (cv2.cvtColor(value, cv2.COLOR_RGB2BGR)
                       if is_rgb_order and value.ndim == 3 and value.shape[-1] == 3 else value)
                imwrite(img, save_file_path)
