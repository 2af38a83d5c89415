"""Small host-side helpers (counterpart of ``basicsr4rs_tpu/utils/misc.py``;
reference: basicsr/utils/misc.py)."""

from __future__ import annotations

import os
import re
import time
from os import path as osp
from typing import Iterator, Optional


def get_time_str() -> str:
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; if it exists, rename the old one with a timestamp suffix."""
    if osp.exists(path):
        new_name = path + '_archived_' + get_time_str()
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt) -> None:
    """Create the directory tree of a training run (``experiments_root``)
    or a test run (``results_root``) on rank 0; an existing root is renamed
    aside. The rank is read at the call: this module (``scandir`` for the
    data-preparation scripts) imports without torch."""
    from .dist_util import get_dist_info
    if get_dist_info()[0] != 0:
        return
    path_opt = dict(opt['path'])
    mkdir_and_rename(path_opt.pop('experiments_root' if opt['is_train'] else 'results_root'))
    for key, path in path_opt.items():
        if ('strict_load' in key) or ('pretrain_network' in key) or (
                'resume' in key) or ('param_key' in key) or path is None:
            continue
        os.makedirs(path, exist_ok=True)


def scandir(dir_path: str,
            suffix: Optional[str] = None,
            recursive: bool = False,
            full_path: bool = False) -> Iterator[str]:
    """Yield the non-hidden files under ``dir_path`` whose names end in
    ``suffix``, relative to it unless ``full_path``."""
    if not (suffix is None or isinstance(suffix, (str, tuple))):
        raise TypeError('"suffix" must be a string or tuple of strings')

    root = dir_path

    def _scandir(dir_path):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith('.') and entry.is_file():
                return_path = entry.path if full_path else osp.relpath(entry.path, root)
                if suffix is None or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path)

    return _scandir(dir_path)


def check_resume(opt, resume_iter: int) -> None:
    """On resume, point every ``pretrain_network_*`` at the checkpoint of the
    resumed iteration, ``models/net_<label>_<iter>.pth``, unless
    ``ignore_resume_networks`` lists the network."""
    if not opt['path'].get('resume_state'):
        return
    networks = [key for key in opt.keys() if key.startswith('network_')]
    if any(opt['path'].get(f'pretrain_{network}') is not None for network in networks):
        print('pretrain_network paths will be ignored during resuming.', flush=True)
    ignored = opt['path'].get('ignore_resume_networks') or ()
    for network in networks:
        if network in ignored:
            continue
        name = f'pretrain_{network}'
        label = network.replace('network_', '')
        opt['path'][name] = osp.join(opt['path']['models'], f'net_{label}_{resume_iter}.pth')
        print(f"Set {name} to {opt['path'][name]}", flush=True)
        # an EMA network resumes from params_ema of the same file
        if opt['path'].get(f'param_key_{label}') == 'params_ema':
            opt['path'][f'param_key_{label}'] = 'params'
            print(f'Set param_key_{label} to params', flush=True)


def find_latest_checkpoint_iter(state_dir: str) -> Optional[int]:
    """The largest iteration that has a ``<iter>.state`` under ``state_dir``,
    or None: what ``--auto_resume`` resumes from."""
    if not osp.isdir(state_dir):
        return None
    iters = [int(m.group(1)) for m in (re.fullmatch(r'(\d+)\.state', name)
                                       for name in os.listdir(state_dir)) if m]
    return max(iters) if iters else None
