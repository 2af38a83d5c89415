"""Metric registry and dispatcher (counterpart of
``basicsr4rs_tpu/metrics/__init__.py``)."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_psnr, calculate_ssim

__all__ = ['calculate_metric', 'calculate_psnr', 'calculate_ssim']


def calculate_metric(data, opt):
    """Evaluate the metric named by ``opt['type']`` on ``data``."""
    opt = deepcopy(opt)
    return METRIC_REGISTRY.get(opt.pop('type'))(**data, **opt)
