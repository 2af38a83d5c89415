"""Metric registry and dispatcher (counterpart of
``basicsr4rs_tpu/metrics/__init__.py``)."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .fid import calculate_fid, extract_inception_features, load_patched_inception_v3
from .lpips import calculate_lpips_band, calculate_lpips_none
from .niqe import calculate_niqe, calculate_niqe_band, calculate_niqe_none, calculate_rs_niqe
from .psnr_ssim import (calculate_psnr, calculate_psnr_band, calculate_psnr_pt, calculate_ssim,
                        calculate_ssim_band, calculate_ssim_pt)

__all__ = ['calculate_metric', 'calculate_psnr', 'calculate_ssim', 'calculate_psnr_band',
           'calculate_ssim_band', 'calculate_psnr_pt', 'calculate_ssim_pt', 'calculate_niqe',
           'calculate_rs_niqe', 'calculate_niqe_band', 'calculate_niqe_none', 'calculate_fid',
           'extract_inception_features', 'load_patched_inception_v3', 'calculate_lpips_band',
           'calculate_lpips_none']


def calculate_metric(data, opt):
    """Evaluate the metric named by ``opt['type']`` on ``data``."""
    opt = deepcopy(opt)
    return METRIC_REGISTRY.get(opt.pop('type'))(**data, **opt)
