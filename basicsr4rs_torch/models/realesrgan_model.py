"""RealESRGANModel, Real-ESRGAN's GAN stage with its training pairs
synthesised on the model's device (counterpart of
``basicsr4rs_tpu/models/realesrgan_model.py``; reference:
basicsr/models/realesrgan_model.py).

``SRGANModel``'s step on the batches of ``_SynthesisMixin.feed_data``
(``realesrnet_model.py``), each loss against its own target: the pixel
loss against ``gt_usm`` unless ``l1_gt_usm: false``, the perceptual loss
unless ``percep_gt_usm: false``, and the discriminator's real batch only
with ``gan_gt_usm: true``; LDL's artifact map always reads the plain GT.
"""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .realesrnet_model import _SynthesisMixin
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class RealESRGANModel(_SynthesisMixin, SRGANModel):

    def __init__(self, opt):
        super().__init__(opt)
        self._init_synthesis()

    def loss_targets(self):
        return tuple(self.gt_usm if self.opt.get(flag, default) else self.gt for flag, default in
                     (('l1_gt_usm', True), ('percep_gt_usm', True), ('gan_gt_usm', False)))
