from .color_util import bgr2ycbcr, rgb2ycbcr, ycbcr2bgr, ycbcr2rgb
from .dist_util import get_dist_info, master_only
from .img_util import imfrombytes, img2tensor, imwrite, tensor2img
from .logger import get_env_info, get_root_logger
from .misc import get_time_str, make_exp_dirs, mkdir_and_rename, scandir
from .options import dict2str, ordered_yaml, parse_options, set_random_seed, yaml_load
from .registry import ARCH_REGISTRY, DATASET_REGISTRY, METRIC_REGISTRY, MODEL_REGISTRY, Registry

__all__ = [
    'bgr2ycbcr', 'rgb2ycbcr', 'ycbcr2bgr', 'ycbcr2rgb',
    'get_dist_info', 'master_only',
    'imfrombytes', 'img2tensor', 'imwrite', 'tensor2img',
    'get_env_info', 'get_root_logger',
    'get_time_str', 'make_exp_dirs', 'mkdir_and_rename', 'scandir',
    'dict2str', 'ordered_yaml', 'parse_options', 'set_random_seed', 'yaml_load',
    'ARCH_REGISTRY', 'DATASET_REGISTRY', 'METRIC_REGISTRY', 'MODEL_REGISTRY', 'Registry',
]
