"""L2SSingleModel, Landsat -> Sentinel paired training (counterpart of
``basicsr4rs_tpu/models/srrs_l2s_model.py``; reference:
basicsr/models/srrs_l2s_model.py).

The L2S datasets give nested ``{'rgb', 'nss'}`` groups. ``feed_data`` puts
the LQ groups side by side on the channel axis (6 bands) and the GT groups
likewise, the GT's NSS group bicubically upsampled x2 to the RGB grid on the
model's device first (``archs.arch_util.resize_bicubic``, which the JAX
package's matches). Validation names each image ``tile_window_time`` and
saves the RGB and the NSS bands as separate PNGs."""

from __future__ import annotations

from os import path as osp

import torch

from ..archs.arch_util import resize_bicubic
from ..utils.registry import MODEL_REGISTRY
from .srrs_model import SRRSModel


def concat_groups(groups: dict, device: torch.device, upsample_nss: bool) -> torch.Tensor:
    """(B, 6, H, W) of a batch's RGB and NSS groups on ``device``, the NSS
    group first enlarged x2 where it lies on half the RGB grid."""
    rgb = groups['rgb'].to(device, non_blocking=True)
    nss = groups['nss'].to(device, non_blocking=True)
    if upsample_nss:
        nss = resize_bicubic(nss, 2.0)
    return torch.cat([rgb, nss], dim=1)


def flatten_groups(data: dict, device: torch.device) -> dict:
    """The batch with its band groups side by side on ``device``: ``lq``,
    and ``gt`` and ``hm`` (Sentinel targets, NSS on half the grid) where
    given; every other key as it is."""
    flat = dict(data, lq=concat_groups(data['lq'], device, upsample_nss=False))
    for key in ('gt', 'hm'):
        if key in data:
            flat[key] = concat_groups(data[key], device, upsample_nss=True)
    return flat


def save_rgb_and_nss(model, dataset: str, img_name: str, images: dict):
    """The first three bands under ``RGB/``, the rest under ``NSS/``."""
    vis_path = model.opt['path']['visualization']
    rgb = {name: img[..., :3] for name, img in images.items()}
    nss = {name: img[..., 3:] for name, img in images.items()
           if img.ndim == 3 and img.shape[-1] > 3}
    model.rswrite(osp.join(vis_path, 'RGB', dataset, img_name), rgb, is_rgb_order=True)
    if nss:
        model.rswrite(osp.join(vis_path, 'NSS', dataset, img_name), nss, is_rgb_order=True)


@MODEL_REGISTRY.register()
class L2SSingleModel(SRRSModel):

    def feed_data(self, data):
        self.batch_meta = {'sample_path': data.get('sample_path'),
                           'img_name': data.get('img_name')}
        super().feed_data(flatten_groups(data, self.device))

    def _extract_img_name(self, val_data: dict) -> str:
        return val_data['img_name'][0]

    def _save_visuals(self, dataset: str, img_name: str, images: dict):
        save_rgb_and_nss(self, dataset, img_name, images)
