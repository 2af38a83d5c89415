"""MATLAB-exact bicubic LR images, and optionally the LR images enlarged
back (counterpart of ``scripts/data_preparation/generate_bicubic_lr.py``;
reference: scripts/matlab_scripts/generate_bicubic_img.m).

    python -m basicsr4rs_torch.scripts.data_preparation.generate_bicubic_lr \
        --input datasets/DIV2K/DIV2K_train_HR_sub \
        --output datasets/DIV2K/DIV2K_train_LR_bicubic_X4_sub [--scale 4] \
        [--bicubic_restore <folder>]

Every image under ``--input`` (recursively) is cropped to a multiple of the
scale, shrunk by ``utils.matlab_functions.imresize`` in float64 and written,
rounded to uint8, under the same relative path in ``--output``. ``--mod`` is
accepted and, as in the JAX package's script, writes nothing: no cropped GT
is saved.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2
import numpy as np

from ...utils.matlab_functions import imresize
from ...utils.misc import scandir


def to_uint8(img):
    return np.clip(img * 255, 0, 255).round().astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True, help='GT folder (recursed)')
    p.add_argument('--output', required=True, help='LR output folder')
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--mod', action='store_true',
                   help='also crop GT to a multiple of scale in place of output/GTmod')
    p.add_argument('--bicubic_restore', default=None,
                   help='optional folder for LR upsampled back to GT size')
    args = p.parse_args(argv)

    for rel in sorted(scandir(args.input, recursive=True)):
        img = cv2.imread(osp.join(args.input, rel), cv2.IMREAD_UNCHANGED)
        if img is None:
            continue
        img = img.astype(np.float64) / 255.
        h, w = img.shape[:2]
        img = img[:h - h % args.scale, :w - w % args.scale]
        lr = imresize(img, 1.0 / args.scale)
        out_path = osp.join(args.output, rel)
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        cv2.imwrite(out_path, to_uint8(lr))
        if args.bicubic_restore:
            bic_path = osp.join(args.bicubic_restore, rel)
            os.makedirs(osp.dirname(bic_path), exist_ok=True)
            cv2.imwrite(bic_path, to_uint8(imresize(lr, float(args.scale))))
        print(rel)


if __name__ == '__main__':
    main()
