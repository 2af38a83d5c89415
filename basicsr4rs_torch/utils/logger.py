"""Rank-aware root logger and environment banner (counterpart of
``basicsr4rs_tpu/utils/logger.py``; reference: basicsr/utils/logger.py), the training loop's message logger
and timers, and the optional TensorBoard / W&B hooks (used only when their
packages import)."""

from __future__ import annotations

import datetime
import logging
import time
from typing import Dict, Optional

from .dist_util import get_dist_info, master_only


class AvgTimer:
    """Sliding-window average of the time between ``record()`` calls."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.
        self.total_time = 0.
        self.count = 0
        self.avg_time = 0.
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self) -> float:
        return self.current_time

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Formats ``[name..][epoch, iter, lr][eta, time (data)] losses`` lines
    and forwards the scalars to TensorBoard."""

    def __init__(self, opt, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.use_tb_logger = opt['logger'].get('use_tb_logger', False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    @master_only
    def __call__(self, log_vars: Dict):
        current_iter = log_vars.pop('iter')
        epoch = log_vars.pop('epoch')
        lrs = log_vars.pop('lrs')

        message = f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:('
        message += ''.join(f'{v:.3e},' for v in lrs) + ')] '

        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time')
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            message += f'[eta: {datetime.timedelta(seconds=int(eta_sec))}, '
            message += f'time (data): {iter_time:.3f} ({data_time:.3f})] '

        for k, v in log_vars.items():
            message += f'{k}: {v:.4e} '
            if self.tb_logger is not None:
                self.tb_logger.add_scalar(f'losses/{k}' if k.startswith('l_') else k, v,
                                          current_iter)
        self.logger.info(message)


@master_only
def init_tb_logger(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        get_root_logger().warning('tensorboard is not available; TB logging disabled.')
        return None
    return SummaryWriter(log_dir=log_dir)


@master_only
def init_wandb_logger(opt):
    """W&B in tensorboard-sync mode; optional."""
    try:
        import wandb
    except ImportError:
        get_root_logger().warning('wandb is not available; wandb logging disabled.')
        return None
    logger = get_root_logger()
    project = opt['logger']['wandb']['project']
    resume_id = opt['logger']['wandb'].get('resume_id')
    if resume_id:
        wandb_id, resume = resume_id, 'allow'
        logger.warning(f'Resume wandb logger with id={wandb_id}.')
    else:
        wandb_id, resume = wandb.util.generate_id(), 'never'
    wandb.init(id=wandb_id, resume=resume, name=opt['name'], config=opt, project=project,
               sync_tensorboard=True)
    logger.info(f'Use wandb logger with id={wandb_id}; project={project}.')
    return wandb


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
