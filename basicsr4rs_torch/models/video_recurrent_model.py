"""VideoRecurrentModel (counterpart of
``basicsr4rs_tpu/models/video_recurrent_model.py``; reference:
basicsr/models/video_recurrent_model.py).

Training and validation items are whole clips, (B, T, C, H, W). The optical
flow network learns at ``train.flow_lr_mul`` times the rate, and before
iteration ``train.fix_flow`` its updates (and those of a keyframe ``edvr``
branch) are discarded. Validation runs each clip in one forward, optionally
averaged with the reversed clip (``val.flip_seq``) or cut to its centre frame
(``val.center_frame_only``). On several ranks each rank validates the
clips ``rank::world_size``; where the clip count does not divide, the tail
ranks run the last clip again without recording it, so that every rank
reaches the metric merge after as many forwards.

``VideoRecurrentGANModel`` trains as ``SRGANModel`` and validates as
``VideoRecurrentModel``; the discriminator sees the frames folded into the
batch. As in the JAX package, whose GAN step has no flow hooks, neither
``flow_lr_mul`` nor ``fix_flow`` reaches it: the flow network learns at the
generator's rate from the first iteration (BasicSR's ``lr_flow`` is read by
neither package). ``VideoGANModel`` is the same GAN over ``VideoBaseModel``'s
windows.
"""

from __future__ import annotations

from os import path as osp

import torch

from ..data import default_collate
from ..metrics import calculate_metric
from ..utils.img_util import imwrite, tensor2img
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .srgan_model import SRGANModel
from .video_base_model import VideoBaseModel


@MODEL_REGISTRY.register()
class VideoRecurrentModel(VideoBaseModel):

    def __init__(self, opt):
        train_opt = opt.get('train') or {}
        self.fix_flow_iter = train_opt.get('fix_flow') or 0
        self.flow_lr_mul = train_opt.get('flow_lr_mul', 1.)
        super().__init__(opt)

    def lr_multiplier(self, name):
        return float(self.flow_lr_mul) if 'spynet' in name else 1.

    def frozen_parameters(self, current_iter):
        if not self.fix_flow_iter or current_iter >= self.fix_flow_iter:
            return []
        return [p for name, p in self.get_bare_model(self.net_g).named_parameters()
                if 'spynet' in name or 'edvr' in name]

    def optimize_parameters(self, current_iter):
        if self.fix_flow_iter and current_iter == 1:
            get_root_logger().info(
                f'Fix flow network and feature extractor for {self.fix_flow_iter} iters.')
        elif self.fix_flow_iter and current_iter == self.fix_flow_iter:
            get_root_logger().warning('Train all the parameters.')
        super().optimize_parameters(current_iter)

    def test(self):
        lq = self.lq
        flip_seq = self.opt['val'].get('flip_seq', False)
        if flip_seq:
            lq = torch.cat([lq, lq.flip(1)], dim=1)
        output = self._eval_forward(lq)
        if flip_seq:
            t = output.shape[1] // 2
            output = 0.5 * (output[:, :t] + output[:, t:].flip(1))
        if self.opt['val'].get('center_frame_only', False):
            output = output[:, output.shape[1] // 2]
        self.output = output

    def _strided_items(self, dataset):
        """The clips ``rank::world_size``, padded with unrecorded runs of the
        last clip up to a multiple of the rank count (the JAX package's and
        BasicSR's rule)."""
        rank, world_size = self.opt['rank'], self.opt['world_size']
        num_folders = len(dataset)
        num_pad = (world_size - num_folders % world_size) % world_size
        if rank == 0 and num_pad:
            get_root_logger().info(f'{num_pad} padding folders added to keep validation '
                                   'in step')
        for i in range(rank, num_folders + num_pad, world_size):
            yield default_collate([dataset[min(i, num_folders - 1)]]), i < num_folders

    def _validate_item(self, val_data, dataset_name, save_img, with_metrics, record=True):
        """One clip: every frame's output, image and metric row (none of them
        kept unless ``record``)."""
        folder = val_data['folder'][0]
        self.feed_data(val_data)
        self.test()
        visuals = self.get_current_visuals()
        result = visuals['result'][0]                   # (T, C, H, W), or (C, H, W)
        gt = visuals['gt'][0] if 'gt' in visuals else None
        if gt is not None:
            del self.gt
        if not record:
            return
        if self.opt['val'].get('center_frame_only', False):
            # the one frame takes metric row 0
            result = result.unsqueeze(0)
            if gt is not None:   # a clip's GT, or one frame's (Vimeo90K's test set)
                gt = gt.unsqueeze(0) if gt.dim() == 3 else gt[gt.shape[0] // 2].unsqueeze(0)

        for frame_idx in range(result.shape[0]):
            metric_data = {'img': tensor2img(result[frame_idx])}
            if gt is not None:
                metric_data['img2'] = tensor2img(gt[frame_idx])
            if save_img:
                if self.is_train:
                    raise NotImplementedError('saving image is not supported during training.')
                imwrite(metric_data['img'],
                        osp.join(self.opt['path']['visualization'], dataset_name, folder,
                                 f'{frame_idx:08d}_{self.opt["name"]}.png'))
            if with_metrics:
                # added, as BasicSR does: a Vimeo90K test set's septuplets are
                # one folder, each item its centre frame in row 0, and the
                # folder's mean over its rows is then the mean over the items
                for metric_idx, opt_ in enumerate(self.opt['val']['metrics'].values()):
                    self.metric_results_per_folder[folder][frame_idx, metric_idx] += (
                        calculate_metric(metric_data, opt_))


def _frames(x):
    """(B, T, C, H, W) -> (B * T, C, H, W) for the frame discriminator."""
    return x.flatten(0, 1) if x.dim() == 5 else x


@MODEL_REGISTRY.register()
class VideoRecurrentGANModel(SRGANModel, VideoRecurrentModel):

    def lr_multiplier(self, name):
        return 1.

    def frozen_parameters(self, current_iter):
        return []

    def _g_gan_loss(self, output):
        return super()._g_gan_loss(_frames(output))

    def _d_losses(self, real, fake):
        return super()._d_losses(_frames(real), _frames(fake))


@MODEL_REGISTRY.register()
class VideoGANModel(SRGANModel, VideoBaseModel):
    """The GAN over the sliding-window model: one output frame an item."""
