from .color_util import bgr2ycbcr, rgb2ycbcr, ycbcr2bgr, ycbcr2rgb
from .dist_util import get_dist_info, master_only
from .img_util import imfrombytes, img2tensor, imwrite, tensor2img
from .logger import (AvgTimer, MessageLogger, get_env_info, get_root_logger, init_tb_logger,
                     init_wandb_logger)
from .misc import (check_resume, find_latest_checkpoint_iter, get_time_str, make_exp_dirs,
                   mkdir_and_rename, scandir)
from .options import (copy_opt_file, dict2str, ordered_yaml, parse_options, set_random_seed,
                      yaml_load)
from .registry import (ARCH_REGISTRY, DATASET_REGISTRY, LOSS_REGISTRY, METRIC_REGISTRY,
                       MODEL_REGISTRY, Registry)

__all__ = [
    'bgr2ycbcr', 'rgb2ycbcr', 'ycbcr2bgr', 'ycbcr2rgb',
    'get_dist_info', 'master_only',
    'imfrombytes', 'img2tensor', 'imwrite', 'tensor2img',
    'AvgTimer', 'MessageLogger', 'get_env_info', 'get_root_logger', 'init_tb_logger',
    'init_wandb_logger',
    'check_resume', 'find_latest_checkpoint_iter', 'get_time_str', 'make_exp_dirs',
    'mkdir_and_rename', 'scandir',
    'copy_opt_file', 'dict2str', 'ordered_yaml', 'parse_options', 'set_random_seed', 'yaml_load',
    'ARCH_REGISTRY', 'DATASET_REGISTRY', 'LOSS_REGISTRY', 'METRIC_REGISTRY', 'MODEL_REGISTRY',
    'Registry',
]
