"""LMDB folders for DIV2K, REDS and Vimeo90K (counterpart of
``scripts/data_preparation/create_lmdb.py``; reference:
scripts/data_preparation/create_lmdb.py). Needs the ``lmdb`` package: without
it the builder raises ``ImportError``.

    python -m basicsr4rs_torch.scripts.data_preparation.create_lmdb --dataset div2k \
        --input datasets/DIV2K/DIV2K_train_HR_sub \
        --output datasets/DIV2K/DIV2K_train_HR_sub.lmdb [--n-thread 40]

Keys: DIV2K the image names without ``.png``; REDS ``<clip>/<frame>``;
Vimeo90K ``<clip>/im1`` to ``<clip>/im7`` of each clip of ``--train-list``.
The images are read in ``--n-thread`` processes first, or in this process
with ``--n-thread 1``.
"""

from __future__ import annotations

import argparse
from os import path as osp

from ...utils.lmdb_util import make_lmdb_from_imgs
from ...utils.misc import scandir


def prepare_keys_div2k(folder):
    paths = sorted(scandir(folder, suffix='png', recursive=False))
    keys = [p.split('.png')[0] for p in paths]
    return paths, keys


def prepare_keys_reds(folder):
    paths = sorted(scandir(folder, suffix='png', recursive=True))
    keys = [p[:-4] for p in paths]   # 000/00000000
    return paths, keys


def prepare_keys_vimeo90k(folder, train_list):
    with open(train_list) as f:
        clips = [line.strip() for line in f if line.strip()]
    paths, keys = [], []
    for clip in clips:
        for i in range(1, 8):
            paths.append(osp.join(clip, f'im{i}.png'))
            keys.append(f'{clip}/im{i}')
    return paths, keys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dataset', choices=['div2k', 'reds', 'vimeo90k'], required=True)
    p.add_argument('--input', required=True, help='image root folder')
    p.add_argument('--output', required=True, help='output .lmdb path')
    p.add_argument('--train-list', help='vimeo90k sep_trainlist.txt')
    p.add_argument('--n-thread', type=int, default=40)
    args = p.parse_args(argv)

    if args.dataset == 'div2k':
        paths, keys = prepare_keys_div2k(args.input)
    elif args.dataset == 'reds':
        paths, keys = prepare_keys_reds(args.input)
    else:
        if not args.train_list:
            p.error('--train-list is required for vimeo90k')
        paths, keys = prepare_keys_vimeo90k(args.input, args.train_list)
    make_lmdb_from_imgs(args.input, args.output, paths, keys,
                        multiprocessing_read=args.n_thread > 1, n_thread=args.n_thread)


if __name__ == '__main__':
    main()
