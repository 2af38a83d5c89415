"""YAML experiment-config parsing (counterpart of
``basicsr4rs_tpu/utils/options.py``; reference: basicsr/utils/options.py).

One YAML file per experiment names the model, network, dataset, loss and
metric types that the registries resolve; ``--force_yml a:b=c`` overrides
entries; ``scale``/``phase`` propagate into the dataset options; a training
run gets the ``experiments/<name>/`` layout, a test run ``results/<name>/``;
``--debug`` (or a name with ``debug`` in it) shrinks the logging, validation
and checkpoint intervals. ``num_gpu`` picks the
device: ``auto`` is ``torch.cuda.device_count()``, ``0`` means the CPU, and a
run that asks for a GPU on a host without one raises instead of falling back
to the CPU. One process drives at most one card: ``num_gpu`` above 1 raises
and names the torchrun command. Under a launcher (``--launcher pytorch``,
``slurm``; ``jax`` is taken as ``pytorch``) each process is one rank on one
card, ``num_gpu`` resolves to 1 (0 where the config says 0) and
``world_size`` carries the count; the group's backend is
``dist_params.backend`` (NCCL by default), gloo with ``num_gpu: 0``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from collections import OrderedDict
from os import path as osp
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from ..parallel.mesh import opt_grid
from .dist_util import TORCHRUN, get_dist_info, init_dist, master_only


def ordered_yaml():
    """(Loader, Dumper) that keep the order of mappings."""
    try:
        from yaml import CDumper as Dumper
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    mapping_tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(mapping_tag, dict_constructor)
    return Loader, Dumper


def yaml_load(f: str) -> Dict[str, Any]:
    """Load YAML from a file path or a YAML string."""
    if os.path.isfile(f):
        with open(f, 'r') as fh:
            return yaml.load(fh, Loader=ordered_yaml()[0])
    if f.endswith(('.yml', '.yaml')) and '\n' not in f:
        raise FileNotFoundError(f'option file not found: {f}')
    return yaml.load(f, Loader=ordered_yaml()[0])


def dict2str(opt: Dict[str, Any], indent_level: int = 1) -> str:
    """Pretty-print a nested option dict."""
    msg = '\n'
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + f'{k}:['
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + f'{k}: {v}\n'
    return msg


def _postprocess_value(v: str) -> Any:
    """Parse a ``--force_yml`` value into None/bool/number/list/str."""
    if v in ('~', 'none', 'None'):
        return None
    if v.lower() == 'true':
        return True
    if v.lower() == 'false':
        return False
    if v.startswith('!!float'):
        return float(v.replace('!!float', ''))
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.startswith('[') and v.endswith(']'):
        return yaml.safe_load(v)
    return v


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def apply_force_yml(opt: Dict[str, Any], force_yml) -> None:
    """Apply ``a:b:c=value`` deep overrides."""
    for entry in force_yml or ():
        keys, value = entry.replace(' ', '').split('=', 1)
        node = opt
        key_list = keys.split(':')
        for key in key_list[:-1]:
            node = node[key]
        node[key_list[-1]] = _postprocess_value(value)


def resolve_num_gpu(num_gpu, dist: bool = False) -> int:
    """``auto`` -> every visible CUDA device; 0 -> the CPU; n >= 1 needs n
    CUDA devices. Raises when the devices asked for are not there, and when
    one process is asked for more than one card. Under a launcher
    (``dist``) every rank drives one card: 1, or 0 where ``num_gpu`` is 0."""
    available = torch.cuda.device_count()
    if dist:
        if num_gpu == 0:
            return 0
        if available == 0:
            raise RuntimeError(f'num_gpu: {num_gpu} under a launcher needs a CUDA device on '
                               'every rank, none visible; set num_gpu: 0 to run on the CPU')
        return 1
    if num_gpu == 'auto':
        num_gpu = available
        if num_gpu == 0:
            raise RuntimeError('num_gpu: auto found no CUDA device; set num_gpu: 0 '
                               'to run on the CPU')
    num_gpu = int(num_gpu)
    if num_gpu > available:
        raise RuntimeError(f'num_gpu: {num_gpu} asks for CUDA devices, {available} '
                           'visible; set num_gpu: 0 to run on the CPU')
    if num_gpu > 1:
        command = TORCHRUN.replace(' N', f' {num_gpu}')
        raise RuntimeError(f'num_gpu: {num_gpu} in one process: the port drives one card a '
                           f'process; start {num_gpu} ranks with {command} -m '
                           'basicsr4rs_torch.train -opt <yml> --launcher pytorch, or set '
                           'num_gpu: 1')
    return num_gpu


def parse_options(root_path: str, is_train: bool = False,
                  args: Optional[argparse.Namespace] = None
                  ) -> Tuple[Dict[str, Any], argparse.Namespace]:
    """Parse the command line (``-opt``, ``--launcher``, ``--auto_resume``,
    ``--debug``, ``--force_yml``) and the YAML file into the experiment
    option dict; under a launcher, join the process group first."""
    if args is None:
        parser = argparse.ArgumentParser()
        parser.add_argument('-opt', type=str, required=True, help='Path to option YAML file.')
        parser.add_argument('--launcher', choices=['none', 'jax', 'pytorch', 'slurm'],
                            default='none', help='job launcher')
        parser.add_argument('--auto_resume', action='store_true')
        parser.add_argument('--debug', action='store_true')
        parser.add_argument('--force_yml', nargs='+', default=None,
                            help='Force to update yml files. Example: train:ema_decay=0.999')
        args = parser.parse_args()

    opt = yaml_load(args.opt)
    apply_force_yml(opt, args.force_yml)
    launcher = getattr(args, 'launcher', 'none') or 'none'
    opt['dist'] = launcher != 'none'
    if opt['dist']:
        use_cuda = opt.get('num_gpu', 'auto') != 0
        backend = (opt.get('dist_params') or {}).get('backend', 'nccl') if use_cuda else 'gloo'
        init_dist(launcher, backend, use_cuda)
    rank, world_size = get_dist_info()
    opt['rank'], opt['world_size'] = rank, world_size

    if getattr(args, 'debug', False) and not opt['name'].startswith('debug'):
        opt['name'] = 'debug_' + opt['name']

    seed = opt.get('manual_seed')
    if seed is None:
        seed = [random.randint(1, 10000)]
        if world_size > 1:   # one seed for every rank: rank 0's
            torch.distributed.broadcast_object_list(seed, src=0)
        seed = opt['manual_seed'] = seed[0]
    # each data rank its own stream; the ranks of a spatial group share one
    set_random_seed(seed + opt_grid(opt).data_rank)

    opt['auto_resume'] = getattr(args, 'auto_resume', False)
    opt['is_train'] = is_train
    opt['num_gpu'] = resolve_num_gpu(opt.get('num_gpu', 'auto'), opt['dist'])

    for phase, dataset in (opt.get('datasets') or {}).items():
        dataset['phase'] = phase.split('_')[0]
        if 'scale' in opt:
            dataset['scale'] = opt['scale']
        for key in ('dataroot_gt', 'dataroot_lq'):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    for key, val in opt.get('path', {}).items():
        if (val is not None) and ('resume_state' in key or 'pretrain_network' in key):
            opt['path'][key] = osp.expanduser(val)

    if is_train:
        experiments_root = osp.join(
            opt['path'].get('experiments_root') or osp.join(root_path, 'experiments'),
            opt['name'])
        opt['path']['experiments_root'] = experiments_root
        opt['path']['models'] = osp.join(experiments_root, 'models')
        opt['path']['training_states'] = osp.join(experiments_root, 'training_states')
        opt['path']['log'] = experiments_root
        opt['path']['visualization'] = osp.join(experiments_root, 'visualization')
        if 'debug' in opt['name']:
            if opt.get('val'):
                opt['val']['val_freq'] = 8
            if opt.get('logger'):
                opt['logger']['print_freq'] = 1
                opt['logger']['save_checkpoint_freq'] = 8
    else:
        results_root = osp.join(
            opt['path'].get('results_root') or osp.join(root_path, 'results'), opt['name'])
        opt['path']['results_root'] = results_root
        opt['path']['log'] = results_root
        opt['path']['visualization'] = osp.join(results_root, 'visualization')

    return opt, args


@master_only
def copy_opt_file(opt_file: str, experiments_root: str) -> None:
    """Copy the config into the experiment directory under a header that
    says when and by which command it ran."""
    os.makedirs(experiments_root, exist_ok=True)
    with open(opt_file, 'r') as f:
        lines = f.readlines()
    lines.insert(0, f'# GENERATE TIME: {time.asctime()}\n# CMD:\n# {" ".join(sys.argv)}\n\n')
    with open(osp.join(experiments_root, osp.basename(opt_file)), 'w') as f:
        f.writelines(lines)
