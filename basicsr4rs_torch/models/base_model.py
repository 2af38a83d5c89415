"""BaseModel, eval subset (counterpart of ``basicsr4rs_tpu/models/base_model.py``;
reference: basicsr/models/base_model.py).

The device, network printing, ``.pth`` loading with a param key and strict
key matching, validation dispatch and best-metric tracking. Optimizers,
schedulers, EMA and checkpoint saving come with the train path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import torch
from torch import nn

from ..utils.logger import get_root_logger

# buffers that BasicSR stores and the port computes per input shape
_COMPUTED_BUFFERS = ('relative_position_index', 'attn_mask')


class BaseModel:

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt['is_train']
        self.device = torch.device('cuda' if opt['num_gpu'] != 0 else 'cpu')
        self.best_metric_results: Dict[str, Any] = {}

    def feed_data(self, data):
        pass

    def test(self):
        pass

    def get_current_visuals(self):
        pass

    def validation(self, dataloader, current_iter, tb_logger, save_img: bool = False):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        raise NotImplementedError

    # ------------------------------------------------- best-metric tracking
    def _initialize_best_metric_results(self, dataset_name):
        if dataset_name in self.best_metric_results:
            return
        record = dict()
        for metric, content in self.opt['val']['metrics'].items():
            better = content.get('better', 'higher')
            init_val = float('-inf') if better == 'higher' else float('inf')
            record[metric] = dict(better=better, val=init_val, iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val, current_iter):
        record = self.best_metric_results[dataset_name][metric]
        if (val >= record['val']) if record['better'] == 'higher' else (val <= record['val']):
            record['val'] = val
            record['iter'] = current_iter

    # --------------------------------------------------------------- utils
    def print_network(self, net: nn.Module) -> None:
        n = sum(p.numel() for p in net.parameters())
        get_root_logger().info(f'Network: {net.__class__.__name__}, with parameters: {n:,d}')

    def load_network(self, net: nn.Module, load_path: str, strict: bool = True,
                     param_key: str = 'params') -> None:
        """Load ``load_path`` (a ``.pth`` of ``{param_key: state_dict}`` or a
        bare state_dict) into ``net``. ``params_ema`` falls back to
        ``params``; ``module.`` prefixes and the buffers the port computes
        are dropped; ``strict`` makes any other key difference an error."""
        logger = get_root_logger()
        ckpt = torch.load(load_path, map_location='cpu', weights_only=True)
        if param_key in ckpt:
            state_dict = ckpt[param_key]
        elif param_key == 'params_ema' and 'params' in ckpt:
            logger.info('Loading: params_ema does not exist, use params.')
            state_dict = ckpt['params']
        elif all(torch.is_tensor(v) for v in ckpt.values()):
            state_dict = ckpt
        else:
            raise KeyError(f'param key {param_key} not found in {load_path}; '
                           f'keys: {list(ckpt)[:8]}')
        logger.info(f'Loading {net.__class__.__name__} model from {load_path}, '
                    f'with param key: [{param_key}].')
        state_dict = OrderedDict(
            (k[len('module.'):] if k.startswith('module.') else k, v)
            for k, v in state_dict.items() if not k.endswith(_COMPUTED_BUFFERS))
        net.load_state_dict(state_dict, strict=strict)
