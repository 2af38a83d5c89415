"""Small host-side helpers (counterpart of ``basicsr4rs_tpu/utils/misc.py``;
reference: basicsr/utils/misc.py)."""

from __future__ import annotations

import os
import time
from os import path as osp
from typing import Iterator, Optional

from .dist_util import master_only


def get_time_str() -> str:
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; if it exists, rename the old one with a timestamp suffix."""
    if osp.exists(path):
        new_name = path + '_archived_' + get_time_str()
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


@master_only
def make_exp_dirs(opt) -> None:
    """Create the results directory tree of a test run."""
    path_opt = dict(opt['path'])
    mkdir_and_rename(path_opt.pop('results_root'))
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
