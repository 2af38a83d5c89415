"""L2SSingleHMModel, two targets at once (counterpart of
``basicsr4rs_tpu/models/srrs_l2shm_model.py``; reference:
basicsr/models/srrs_l2shm_model.py).

The network returns ``{'hm': ..., 'gt': ...}``: a prediction in the
histogram-matched Sentinel domain and one in the true Sentinel domain. The
loss is ``hm_loss_weight`` x the pixel loss of the first against
``batch['hm']`` plus ``gt_loss_weight`` x that of the second against the GT, each with the
perceptual loss and its style term where the config asks for them.
No L2S dataset gives ``hm`` (as in the JAX package), so training needs a
batch that carries it. ``test()`` keeps both outputs: ``output`` is the GT
branch, ``output_hm`` the other; validation scores and saves the first."""

from __future__ import annotations

from collections import OrderedDict

from ..utils.registry import MODEL_REGISTRY
from .srrs_l2s_model import flatten_groups
from .srrs_model import SRRSModel


@MODEL_REGISTRY.register()
class L2SSingleHMModel(SRRSModel):

    def __init__(self, opt):
        self.hm_weight = opt.get('hm_loss_weight', 1.0)
        self.gt_weight = opt.get('gt_loss_weight', 1.0)
        super().__init__(opt)

    def feed_data(self, data):
        self.batch_meta = {'img_name': data.get('img_name')}
        flat = flatten_groups(data, self.device)
        super().feed_data(flat)
        if 'hm' in flat:
            self.hm = flat['hm']

    def _extract_img_name(self, val_data: dict) -> str:
        return val_data['img_name'][0]

    def compute_losses(self):
        with self.autocast():
            result = self.net_g(self.lq)
        out_hm, out_gt = result['hm'].float(), result['gt'].float()
        self.output = out_gt
        losses = OrderedDict()
        loss_hm, loss_gt = (
            self.pixel_and_perceptual_losses(out, target, losses,
                                             tuple(f'{n}_{tag}' for n in ('l_pix', 'l_percep',
                                                                          'l_style')))
            for out, target, tag in ((out_hm, self.hm, 'hm'), (out_gt, self.gt, 'gt')))
        return self.hm_weight * loss_hm + self.gt_weight * loss_gt, losses

    def _eval_forward(self, x):
        """The evaluation forward's outputs in float32: a dict of the two
        branches, or one tensor for a network of one."""
        with self.autocast():
            result = super(SRRSModel, self)._eval_forward(x)
        if isinstance(result, dict):
            return {k: v.float() for k, v in result.items()}
        return result.float()

    def keep_outputs(self, result):
        """``output`` and ``output_hm`` of a forward's result."""
        if isinstance(result, dict):
            self.output = result.get('gt', result.get('hm'))
            self.output_hm = result.get('hm')
        else:
            self.output = result

    def test(self):
        self.keep_outputs(self._eval_forward(self.lq))
