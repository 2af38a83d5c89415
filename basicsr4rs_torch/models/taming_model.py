"""TamingModel, the evaluation of a VQGAN's reconstructions (counterpart of
``basicsr4rs_tpu/models/taming_model.py``; reference:
basicsr/models/taming_model.py): an ``SRRSModel`` whose network is the
autoencoder (``VQModelTorch``) and whose input is the GT itself, so that the
validation scores how well the codes rebuild it.

The JAX ``TamingModel`` only evaluates. A training run (one process, or
ranks under a launcher) trains the autoencoder as ``SRRSModel`` does, on the
pixel and perceptual losses of its straight-through reconstruction against
the GT; the codebook gets no gradient and the quantizer's own loss is not
added. On several ranks the network is not wrapped in DDP, whose reducer
refuses a parameter without gradient (the codebook): it starts from rank
0's weights and its gradients are averaged before each step."""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .srrs_model import SRRSModel


@MODEL_REGISTRY.register()
class TamingModel(SRRSModel):

    WRAP_IN_DDP = False

    def feed_data(self, data):
        """``lq`` is the GT when the batch has one, else the batch's ``lq``."""
        if 'gt' in data:
            self.gt = data['gt'].to(self.device, non_blocking=True)
            self.lq = self.gt
        else:
            self.lq = data['lq'].to(self.device, non_blocking=True)
