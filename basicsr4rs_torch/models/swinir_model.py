"""SwinIRModel: reflect-pads the LQ to a multiple of the window before the
forward and crops the output back, on bands of whole window rows under
``parallel: {spatial: N}`` where the padded height allows it (counterpart of
``basicsr4rs_tpu/models/swinir_model.py``; reference:
basicsr/models/swinir_model.py), and its remote-sensing variants, which
compose that padded test with the SRRS behaviours (CSV metrics, [-1, 1]
visuals, the L2S band groups) by inheritance, in the JAX package's method
resolution order."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel
from .srrs_l2s_model import L2SSingleModel
from .srrs_l2shm_model import L2SSingleHMModel
from .srrs_model import SRRSModel


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

    SPATIAL_SHARDING = True

    def band_rows_multiple(self) -> int:
        """A band of the padded LQ holds whole window rows."""
        return self.opt['network_g'].get('window_size', 8)

    def test(self):
        window_size = self.opt['network_g'].get('window_size', 8)
        scale = self.opt.get('scale', 1)
        _, _, h, w = self.lq.shape
        output = self._eval_forward(pad_to_multiple(self.lq, window_size))
        self.output = output[:, :, :h * scale, :w * scale]


@MODEL_REGISTRY.register()
class SwinIRRSModel(SwinIRModel, SRRSModel):
    pass


@MODEL_REGISTRY.register()
class SwinIRL2sModel(SwinIRModel, L2SSingleModel):
    pass


@MODEL_REGISTRY.register()
class SwinIRHMModel(L2SSingleHMModel):
    """The padded test over a network of two branches (``SwinIR_StyleCNN``):
    the window is ``network_g.sr_net_args.window_size``, else
    ``network_g.window_size``; both outputs are cropped back."""

    def test(self):
        net_opt = self.opt['network_g']
        window_size = (net_opt.get('sr_net_args') or {}).get('window_size') \
            or net_opt.get('window_size', 8)
        scale = self.opt.get('scale', 1)
        _, _, h, w = self.lq.shape
        result = self._eval_forward(pad_to_multiple(self.lq, window_size))

        def crop(img):
            return img[:, :, :h * scale, :w * scale]

        self.keep_outputs({k: crop(v) for k, v in result.items()} if isinstance(result, dict)
                          else crop(result))
