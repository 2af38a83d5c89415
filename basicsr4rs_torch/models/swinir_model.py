"""SwinIRModel: reflect-pads the LQ to a multiple of the window before the
forward and crops the output back (counterpart of
``basicsr4rs_tpu/models/swinir_model.py``; reference:
basicsr/models/swinir_model.py). The remote-sensing variants come later."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Reflect-pad NCHW H/W up to the next multiple. The reference's
    flip-and-concatenate pad equals reflection while the pad is smaller than
    the size, and torch's reflection pad takes no larger pad."""
    _, _, h, w = x.shape
    mod_pad_h = (multiple - h % multiple) % multiple
    mod_pad_w = (multiple - w % multiple) % multiple
    if mod_pad_h == 0 and mod_pad_w == 0:
        return x
    return F.pad(x, (0, mod_pad_w, 0, mod_pad_h), mode='reflect')


@MODEL_REGISTRY.register()
class SwinIRModel(SRModel):

    def test(self):
        window_size = self.opt['network_g'].get('window_size', 8)
        scale = self.opt.get('scale', 1)
        _, _, h, w = self.lq.shape
        output = self._eval_forward(pad_to_multiple(self.lq, window_size))
        self.output = output[:, :, :h * scale, :w * scale]
