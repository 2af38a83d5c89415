"""Network builder with auto-discovery (counterpart of
``basicsr4rs_tpu/archs/__init__.py``; reference: basicsr/archs/__init__.py)."""

from __future__ import annotations

import importlib
from copy import deepcopy
from os import path as osp

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import ARCH_REGISTRY

__all__ = ['build_network']

# import every '*_arch.py' so that its registry decorators run
_arch_folder = osp.dirname(osp.abspath(__file__))
_arch_modules = [importlib.import_module(f'basicsr4rs_torch.archs.{osp.splitext(v)[0]}')
                 for v in sorted(scandir(_arch_folder)) if v.endswith('_arch.py')]


def build_network(opt):
    """Instantiate the network named by ``opt['type']``."""
    opt = deepcopy(opt)
    net = ARCH_REGISTRY.get(opt.pop('type'))(**opt)
    get_root_logger().info(f'Network [{net.__class__.__name__}] is created.')
    return net
