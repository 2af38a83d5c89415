"""Helpers of the port, each imported from its module on first use, so that
importing one module of the package (``utils.serving`` for a server) loads
no other."""

import importlib

_MODULES = {
    'color_util': ('bgr2ycbcr', 'rgb2ycbcr', 'ycbcr2bgr', 'ycbcr2rgb'),
    'dist_util': ('get_dist_info', 'master_only'),
    'img_util': ('imfrombytes', 'img2tensor', 'imwrite', 'tensor2img'),
    'logger': ('AvgTimer', 'MessageLogger', 'get_env_info', 'get_root_logger', 'init_tb_logger',
               'init_wandb_logger'),
    'misc': ('check_resume', 'find_latest_checkpoint_iter', 'get_time_str', 'make_exp_dirs',
             'mkdir_and_rename', 'scandir'),
    'options': ('copy_opt_file', 'dict2str', 'ordered_yaml', 'parse_options', 'set_random_seed',
                'yaml_load'),
    'registry': ('ARCH_REGISTRY', 'DATASET_REGISTRY', 'LOSS_REGISTRY', 'METRIC_REGISTRY',
                 'MODEL_REGISTRY', 'Registry'),
}
_HOME = {name: module for module, names in _MODULES.items() for name in names}

__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f'.{_HOME[name]}', __name__), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
