"""TamingModel, the evaluation of a VQGAN's reconstructions (counterpart of
``basicsr4rs_tpu/models/taming_model.py``; reference:
basicsr/models/taming_model.py): an ``SRRSModel`` whose network is the
autoencoder (``VQModelTorch``) and whose input is the GT itself, so that the
validation scores how well the codes rebuild it."""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .srrs_model import SRRSModel


@MODEL_REGISTRY.register()
class TamingModel(SRRSModel):

    SINGLE_RANK_ONLY = 'TamingModel under DDP'

    def feed_data(self, data):
        """``lq`` is the GT when the batch has one, else the batch's ``lq``."""
        if 'gt' in data:
            self.gt = data['gt'].to(self.device, non_blocking=True)
            self.lq = self.gt
        else:
            self.lq = data['lq'].to(self.device, non_blocking=True)
