"""Model builder with auto-discovery (counterpart of
``basicsr4rs_tpu/models/__init__.py``; reference: basicsr/models/__init__.py)."""

from __future__ import annotations

import importlib
from copy import deepcopy
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import MODEL_REGISTRY

__all__ = ['build_model']

# import every '*_model.py' so that its registry decorators run
_model_folder = osp.dirname(osp.abspath(__file__))
_model_modules = [importlib.import_module(f'basicsr4rs_torch.models.{osp.splitext(v)[0]}')
                  for v in sorted(scandir(_model_folder)) if v.endswith('_model.py')]


def build_model(opt):
    """Instantiate a model by its ``model_type`` key."""
    opt = deepcopy(opt)
    model = MODEL_REGISTRY.get(opt['model_type'])(opt)
    get_root_logger().info(f'Model [{model.__class__.__name__}] is created.')
    return model
