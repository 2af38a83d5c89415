"""SRModel, eval path (counterpart of ``basicsr4rs_tpu/models/sr_model.py``;
reference: basicsr/models/sr_model.py).

Builds ``network_g`` on the model's device, loads ``pretrain_network_g``,
and validates: each item of the loader is one request, run forward under
``torch.inference_mode()``, scored with the configured metrics and saved.
Training, EMA and self-ensemble testing come with the train path.
"""

from __future__ import annotations

from collections import OrderedDict
from os import path as osp

import torch

from ..archs import build_network
from ..metrics import calculate_metric
from ..utils.img_util import imwrite, tensor2img
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt):
        super().__init__(opt)
        if self.is_train:
            raise NotImplementedError('SRModel: the train path is not ported yet')
        self.net_g = build_network(opt['network_g']).to(self.device)
        self.print_network(self.net_g)
        load_path = self.opt['path'].get('pretrain_network_g')
        if load_path is not None:
            self.load_network(self.net_g, load_path, self.opt['path'].get('strict_load_g', True),
                              self.opt['path'].get('param_key_g', 'params'))
        self.net_g.eval()

    def feed_data(self, data):
        self.lq = data['lq'].to(self.device)
        if 'gt' in data:
            self.gt = data['gt'].to(self.device)

    def test(self):
        with torch.inference_mode():
            self.output = self.net_g(self.lq)

    def get_current_visuals(self):
        out_dict = OrderedDict()
        out_dict['lq'] = self.lq.detach().cpu()
        out_dict['result'] = self.output.detach().cpu()
        if hasattr(self, 'gt'):
            out_dict['gt'] = self.gt.detach().cpu()
        return out_dict

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        dataset_name = dataloader.dataset.opt['name']
        val_opt = self.opt['val']
        if val_opt.get('selfensemble_testing', False):
            raise NotImplementedError('SRModel: self-ensemble testing is not ported yet')
        with_metrics = val_opt.get('metrics') is not None
        if with_metrics:
            self.metric_results = {metric: 0 for metric in val_opt['metrics']}
            self._initialize_best_metric_results(dataset_name)

        cnt = 0
        for val_data in dataloader:
            img_name = osp.splitext(osp.basename(val_data['lq_path'][0]))[0]
            self.feed_data(val_data)
            self.test()

            visuals = self.get_current_visuals()
            metric_data = {'img': tensor2img(visuals['result'])}
            if 'gt' in visuals:
                metric_data['img2'] = tensor2img(visuals['gt'])
                del self.gt

            if save_img:
                tag = val_opt.get('suffix') or self.opt['name']
                imwrite(metric_data['img'], osp.join(self.opt['path']['visualization'],
                                                     dataset_name, f'{img_name}_{tag}.png'))

            if with_metrics:
                for name, opt_ in val_opt['metrics'].items():
                    self.metric_results[name] += calculate_metric(metric_data, opt_)
            cnt += 1

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
