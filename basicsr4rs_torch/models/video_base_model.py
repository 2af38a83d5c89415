"""VideoBaseModel and EDVRModel (counterpart of
``basicsr4rs_tpu/models/video_base_model.py``; reference:
basicsr/models/video_base_model.py, basicsr/models/edvr_model.py).

``VideoBaseModel``: each validation item is a window of frames and the output
its centre frame; metrics are kept per clip and frame, averaged per clip and
then over the clips. ``EDVRModel`` adds EDVR's training schedule: only the
TSA fusion trains before iteration ``tsa_iter``, and the deformable
convolutions' parameters learn at ``dcn_lr_mul`` times the rate. On several
ranks, validation strides the frames over the ranks and merges the metric
rows with one sum (``dist_validation``).
"""

from __future__ import annotations

from collections import Counter
from os import path as osp

import numpy as np

from ..data import default_collate
from ..metrics import calculate_metric
from ..utils.dist_util import sum_across_processes
from ..utils.img_util import imwrite, tensor2img
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):

    def _init_folder_metric_results(self, dataset):
        """A zero (frames, metrics) array per clip."""
        num_frame_each_folder = Counter(dataset.data_info['folder'])
        self.metric_results_per_folder = {
            folder: np.zeros((num_frame, len(self.opt['val']['metrics'])), np.float32)
            for folder, num_frame in num_frame_each_folder.items()}

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        with_metrics = self.opt['val'].get('metrics') is not None
        if with_metrics:
            self._init_folder_metric_results(dataset)
            self._initialize_best_metric_results(dataset_name)
        for val_data in dataloader:
            self._validate_item(val_data, dataset_name, save_img, with_metrics)
        if with_metrics:
            self._log_video_metrics(current_iter, dataset_name, tb_logger)

    def _strided_items(self, dataset):
        """(item, whether to record it) of this rank: items ``rank::world_size``
        (frame windows here; whole clips in ``VideoRecurrentModel``)."""
        rank, world_size = self.opt['rank'], self.opt['world_size']
        for i in range(rank, len(dataset), world_size):
            yield default_collate([dataset[i]]), True

    def dist_validation(self, dataloader, current_iter, tb_logger, save_img):
        """Each rank validates its stride of the items into zeroed metric
        rows, one ``sum_across_processes`` merges the rows, and every rank
        then holds the same averages (rank 0 logs them)."""
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        with_metrics = self.opt['val'].get('metrics') is not None
        if with_metrics:
            self._init_folder_metric_results(dataset)
            self._initialize_best_metric_results(dataset_name)
        for val_data, record in self._strided_items(dataset):
            self._validate_item(val_data, dataset_name, save_img, with_metrics, record)
        if with_metrics:
            folders = list(self.metric_results_per_folder)
            rows = [len(self.metric_results_per_folder[f]) for f in folders]
            merged = sum_across_processes(
                np.concatenate([self.metric_results_per_folder[f] for f in folders]), self.device)
            self.metric_results_per_folder = dict(zip(folders, np.split(merged,
                                                                        np.cumsum(rows)[:-1])))
            self._log_video_metrics(current_iter, dataset_name, tb_logger)

    def _validate_item(self, val_data, dataset_name, save_img, with_metrics, record=True):
        """One window of frames: its centre frame's output, image and metric
        row (none of them kept unless ``record``)."""
        folder = val_data['folder'][0]
        frame_idx = val_data['idx'][0].split('/')[0]
        self.feed_data(val_data)
        self.test()
        visuals = self.get_current_visuals()
        metric_data = {'img': tensor2img(visuals['result'])}
        if 'gt' in visuals:
            metric_data['img2'] = tensor2img(visuals['gt'])
            del self.gt
        if not record:
            return

        if save_img:
            if self.is_train:
                raise NotImplementedError('saving image is not supported during training.')
            lq_path = val_data['lq_path'][0]
            if 'vimeo' in dataset_name.lower():   # <sequence>_<clip>_<frame>
                split_result = lq_path.split('/')
                img_name = f'{split_result[-3]}_{split_result[-2]}_{split_result[-1].split(".")[0]}'
            else:
                img_name = osp.splitext(osp.basename(lq_path))[0]
            tag = self.opt['val'].get('suffix') or self.opt['name']
            imwrite(metric_data['img'], osp.join(self.opt['path']['visualization'], dataset_name,
                                                 folder, f'{img_name}_{tag}.png'))

        if with_metrics:
            for metric_idx, opt_ in enumerate(self.opt['val']['metrics'].values()):
                self.metric_results_per_folder[folder][int(frame_idx), metric_idx] = (
                    calculate_metric(metric_data, opt_))

    def _log_video_metrics(self, current_iter, dataset_name, tb_logger):
        """Average over each clip's frames, then over the clips."""
        metric_names = list(self.opt['val']['metrics'].keys())
        metric_results_avg = {folder: rows.mean(axis=0)
                              for folder, rows in self.metric_results_per_folder.items()}
        total_avg = np.stack(list(metric_results_avg.values())).mean(axis=0)
        self.metric_results = {name: float(total_avg[i]) for i, name in enumerate(metric_names)}
        for name, value in self.metric_results.items():
            self._update_best_metric_result(dataset_name, name, value, current_iter)

        log_str = f'Validation {dataset_name}\n'
        for metric_idx, name in enumerate(metric_names):
            log_str += f'\t # {name}: {total_avg[metric_idx]:.4f}'
            for folder, folder_avg in metric_results_avg.items():
                log_str += f'\t # {folder}: {folder_avg[metric_idx]:.4f}'
            record = self.best_metric_results[dataset_name][name]
            log_str += f'\n\t    Best: {record["val"]:.4f} @ {record["iter"]} iter\n'
        get_root_logger().info(log_str)
        if tb_logger:
            for metric_idx, name in enumerate(metric_names):
                tb_logger.add_scalar(f'metrics/{name}', float(total_avg[metric_idx]), current_iter)
                for folder, folder_avg in metric_results_avg.items():
                    tb_logger.add_scalar(f'metrics/{name}/{folder}',
                                         float(folder_avg[metric_idx]), current_iter)


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):
    """``train.tsa_iter``: before that iteration only the TSA fusion's
    updates are kept; every parameter trains from it on. ``train.dcn_lr_mul``:
    the factor on the learning rate of the parameters named ``dcn``."""

    def __init__(self, opt):
        train_opt = opt.get('train') or {}
        self.tsa_iter = train_opt.get('tsa_iter') or 0
        self.dcn_lr_mul = train_opt.get('dcn_lr_mul', 1.)
        super().__init__(opt)

    def lr_multiplier(self, name):
        return float(self.dcn_lr_mul) if 'dcn' in name else 1.

    def frozen_parameters(self, current_iter):
        if not self.tsa_iter or current_iter >= self.tsa_iter:
            return []
        return [p for name, p in self.get_bare_model(self.net_g).named_parameters()
                if 'fusion' not in name.split('.')]

    def optimize_parameters(self, current_iter):
        if self.tsa_iter and current_iter == 1:
            get_root_logger().info(f'Only train TSA module for {self.tsa_iter} iters.')
        elif self.tsa_iter and current_iter == self.tsa_iter:
            get_root_logger().warning('Train all the parameters.')
        super().optimize_parameters(current_iter)
