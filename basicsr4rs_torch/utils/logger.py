"""Rank-aware root logger and environment banner (counterpart of
``basicsr4rs_tpu/utils/logger.py``; reference: basicsr/utils/logger.py).
The training-loop message logger and the TensorBoard/W&B hooks come with
the train path."""

from __future__ import annotations

import logging
from typing import Optional

from .dist_util import get_dist_info


def get_root_logger(logger_name: str = 'basicsr4rs_torch',
                    log_level: int = logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The package logger: a stream handler, plus a file handler on the
    first call that names ``log_file``; ranks other than 0 log errors only."""
    logger = logging.getLogger(logger_name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter('%(asctime)s %(levelname)s: %(message)s'))
        logger.addHandler(handler)
        logger.propagate = False
    if get_dist_info()[0] != 0:
        logger.setLevel('ERROR')
        return logger
    logger.setLevel(log_level)
    if log_file is not None and not any(isinstance(h, logging.FileHandler)
                                        for h in logger.handlers):
        file_handler = logging.FileHandler(log_file, 'w')
        file_handler.setFormatter(logging.Formatter('%(asctime)s %(levelname)s: %(message)s'))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    return logger


def get_env_info() -> str:
    """Version banner: the package, torch, CUDA and the device."""
    import torch

    from .. import __version__
    if torch.cuda.is_available():
        device = (f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')
    else:
        device = 'CPU only'
    return (f'\nVersion Information: '
            f'\n\tbasicsr4rs_torch: {__version__}'
            f'\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}'
            f'\n\tDevices: {device}')
