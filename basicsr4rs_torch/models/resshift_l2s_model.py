"""ResShift over the L2S band groups (counterpart of
``basicsr4rs_tpu/models/resshift_l2s_model.py``; reference:
basicsr/models/resshift_l2s_model.py and rsresdiff_hm_model.py).

``ResShiftL2SModel`` feeds the nested ``{'rgb', 'nss'}`` groups as
``L2SSingleModel`` does (6 bands; the first stage encodes and decodes them
three at a time) and trains and samples as ``ResShiftModel``.
``RSResDiffHMModel`` trains against ``data['hm']`` where a batch carries it.
``RSResDiffModel``, the name the published ResDiff configs use, is
``ResShiftL2SModel``."""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .resshift_model import ResShiftModel
from .srrs_l2s_model import flatten_groups, save_rgb_and_nss


@MODEL_REGISTRY.register()
class ResShiftL2SModel(ResShiftModel):

    def feed_data(self, data):
        self.batch_meta = {'sample_path': data.get('sample_path'),
                           'img_name': data.get('img_name')}
        super().feed_data(flatten_groups(data, self.device))

    def _extract_img_name(self, val_data: dict) -> str:
        return val_data['img_name'][0]

    def _save_visuals(self, dataset: str, img_name: str, images: dict):
        save_rgb_and_nss(self, dataset, img_name, images)


@MODEL_REGISTRY.register()
class RSResDiffHMModel(ResShiftL2SModel):
    """The histogram-matched targets under ``data['hm']`` replace the GT."""

    def feed_data(self, data):
        if 'hm' in data:
            data = dict(data, gt=data['hm'])
        super().feed_data(data)


MODEL_REGISTRY.register(ResShiftL2SModel, 'RSResDiffModel')
