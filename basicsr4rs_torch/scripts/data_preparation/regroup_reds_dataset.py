"""Fold the REDS validation clips into the training set as clips 240 to
269 (counterpart of ``scripts/data_preparation/regroup_reds_dataset.py``;
reference: scripts/data_preparation/regroup_reds_dataset.py).

    python -m basicsr4rs_torch.scripts.data_preparation.regroup_reds_dataset \
        [--train-sharp datasets/REDS/train_sharp] [--val-sharp datasets/REDS/val_sharp] \
        [--train-blur <folder> --val-blur <folder>]

Clip ``NNN`` of the validation folder is copied to ``NNN + 240`` of the
training folder, frame by frame.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
from os import path as osp


def regroup(train_folder, val_folder):
    for folder in sorted(glob.glob(osp.join(val_folder, '*'))):
        dst = osp.join(train_folder, f'{int(osp.basename(folder)) + 240:03d}')
        os.makedirs(dst, exist_ok=True)
        for img_path in sorted(glob.glob(osp.join(folder, '*'))):
            shutil.copy(img_path, osp.join(dst, osp.basename(img_path)))
        print(f'{folder} -> {dst}')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--train-sharp', default='datasets/REDS/train_sharp')
    p.add_argument('--val-sharp', default='datasets/REDS/val_sharp')
    p.add_argument('--train-blur', default=None)
    p.add_argument('--val-blur', default=None)
    args = p.parse_args(argv)
    regroup(args.train_sharp, args.val_sharp)
    if args.train_blur and args.val_blur:
        regroup(args.train_blur, args.val_blur)


if __name__ == '__main__':
    main()
