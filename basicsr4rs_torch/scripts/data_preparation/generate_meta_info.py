"""A meta-info file: one ``name (h,w,c)`` line per image of a folder, in
sorted order (counterpart of ``scripts/data_preparation/generate_meta_info.py``;
reference: scripts/data_preparation/generate_meta_info.py).

    python -m basicsr4rs_torch.scripts.data_preparation.generate_meta_info \
        --input datasets/DIV2K/DIV2K_train_HR_sub --output meta_info_DIV2K800sub_GT.txt

Files that do not decode as images are left out.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True, help='image folder')
    p.add_argument('--output', required=True, help='meta_info txt path')
    args = p.parse_args(argv)

    names = sorted(os.listdir(args.input))
    with open(args.output, 'w') as f:
        for idx, name in enumerate(names):
            img = cv2.imread(osp.join(args.input, name), cv2.IMREAD_UNCHANGED)
            if img is None:
                continue
            h, w = img.shape[:2]
            c = 1 if img.ndim == 2 else img.shape[2]
            info = f'{name} ({h},{w},{c})'
            print(idx + 1, info)
            f.write(f'{info}\n')


if __name__ == '__main__':
    main()
