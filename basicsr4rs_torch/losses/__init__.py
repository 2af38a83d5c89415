"""``build_loss`` with auto-discovery of the loss modules (counterpart of
``basicsr4rs_tpu/losses/__init__.py``; reference: basicsr/losses/__init__.py)."""

from __future__ import annotations

import importlib
from copy import deepcopy
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import LOSS_REGISTRY

__all__ = ['build_loss']

# import every '*_loss.py' so that its registry decorators run
_loss_folder = osp.dirname(osp.abspath(__file__))
_loss_modules = [importlib.import_module(f'basicsr4rs_torch.losses.{osp.splitext(v)[0]}')
                 for v in sorted(scandir(_loss_folder)) if v.endswith('_loss.py')]


def build_loss(opt):
    """Instantiate a loss by its ``type`` key."""
    opt = deepcopy(opt)
    loss = LOSS_REGISTRY.get(opt.pop('type'))(**opt)
    get_root_logger().info(f'Loss [{loss.__class__.__name__}] is created.')
    return loss
