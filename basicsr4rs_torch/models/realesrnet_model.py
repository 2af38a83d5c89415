"""RealESRNetModel, Real-ESRGAN's first, pixel-loss stage with its training
pairs synthesised on the model's device (counterpart of
``basicsr4rs_tpu/models/realesrnet_model.py``; reference:
basicsr/models/realesrnet_model.py).

``_SynthesisMixin.feed_data`` takes a training batch of GT crops with their
kernels (``RealESRGANDataset``) and, under ``no_grad``, once a step:
degrades it (``ops/degradation_pipeline.RealESRGANDegrader``, float32 with
TF32 off), crops ``gt_size`` and its LQ at one random offset, passes the
pair through the training-pair pool (``queue_size``, 180 by default), and
sharpens the GT that comes out (``gt_usm``). The batch-level draws and the
crop offset come from a host ``np.random.Generator``, the rest from a
``torch.Generator`` on the device, both seeded from ``manual_seed`` plus the
rank; no step reads the device from the host. A batch without kernels
(validation, or a training batch given as ``lq`` / ``gt``) is fed as it is,
with ``gt_usm`` made from its GT while training. Validation never
synthesises.

``RealESRNetModel`` trains against ``gt_usm`` unless ``gt_usm: false``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.degradation_pipeline import (RealESRGANDegrader, TrainingPairPool, crop_offsets,
                                        paired_random_crop_traced)
from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


class _SynthesisMixin:
    """``feed_data`` with the on-device synthesis and the pair pool."""

    def _init_synthesis(self):
        self.degrader = RealESRGANDegrader(self.opt).to(self.device)
        self.pool = TrainingPairPool(self.opt.get('queue_size', 180))
        # each rank draws the degradations of its own rows
        seed = (self.opt.get('manual_seed') or 0) + self.opt.get('rank', 0)
        self.synth_rng = np.random.default_rng(seed)
        self.synth_generator = torch.Generator(device=self.device).manual_seed(seed)

    def _synthesizes(self, data) -> bool:
        return (self.is_train and self.opt.get('high_order_degradation', True) and 'gt' in data
                and 'kernel1' in data)

    @torch.no_grad()
    def feed_data(self, data):
        if not self._synthesizes(data):
            super().feed_data(data)
            if self.is_train and 'gt' in data:
                self.gt_usm = self.degrader.usm(self.gt)
            return
        with record_function('synthesis'):   # a profiler range, as the SRGAN step's phases
            gt, kernel1, kernel2, sinc_kernel = (data[k].to(self.device, non_blocking=True)
                                                 for k in ('gt', 'kernel1', 'kernel2',
                                                           'sinc_kernel'))
            lq, gt, _ = self.degrader(gt, kernel1, kernel2, sinc_kernel, self.synth_rng,
                                      self.synth_generator)
            gt_size, scale = self.opt['gt_size'], self.opt['scale']
            top, left = crop_offsets(self.synth_rng, lq.shape[-2:], gt_size // scale)
            gt, lq = paired_random_crop_traced(gt, lq, gt_size, scale, top, left)
            lq, gt = self.pool.update(lq.contiguous(), gt.contiguous(), self.synth_generator)
            self.lq, self.gt = lq, gt
            self.gt_usm = self.degrader.usm(gt)   # the pool may have swapped the pair

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        is_train = self.is_train
        self.is_train = False
        try:
            super().nondist_validation(dataloader, current_iter, tb_logger, save_img)
        finally:
            self.is_train = is_train


@MODEL_REGISTRY.register()
class RealESRNetModel(_SynthesisMixin, SRModel):

    def __init__(self, opt):
        super().__init__(opt)
        self._init_synthesis()

    def loss_targets(self):
        target = self.gt_usm if self.opt.get('gt_usm', True) else self.gt
        return target, target, target
