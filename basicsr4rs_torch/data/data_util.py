"""Dataset path helpers (counterpart of ``basicsr4rs_tpu/data/data_util.py``;
reference: basicsr/data/data_util.py). The folder scan is ported; the LMDB
and meta-info-file variants and the video helpers come with their datasets."""

from __future__ import annotations

from os import path as osp
from typing import List, Sequence

from ..utils.misc import scandir


def paired_paths_from_folder(folders: Sequence[str], keys: Sequence[str],
                             filename_tmpl: str) -> List[dict]:
    """Pair the files of two folders by name: each GT file ``name.ext`` with
    the input ``filename_tmpl.format(name).ext``."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError('paired_paths_from_folder takes [input_folder, gt_folder] '
                         'and [input_key, gt_key]')
    input_folder, gt_folder = folders
    input_key, gt_key = keys

    input_names = {osp.basename(p) for p in scandir(input_folder)}
    gt_paths = list(scandir(gt_folder))
    if len(input_names) != len(gt_paths):
        raise ValueError(f'{input_key} and {gt_key} datasets have different number of '
                         f'images: {len(input_names)}, {len(gt_paths)}.')
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        if input_name not in input_names:
            raise ValueError(f'{input_name} is not in {input_key}_paths.')
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_path)})
    return paths
