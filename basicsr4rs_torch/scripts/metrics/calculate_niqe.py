"""NIQE of every image of a folder (counterpart of
``scripts/metrics/calculate_niqe.py``; reference:
scripts/metrics/calculate_niqe.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_niqe --input <dir> [--crop_border 0]
"""

from __future__ import annotations

import argparse
import warnings
from os import path as osp

import cv2
import numpy as np

from ...metrics.niqe import calculate_niqe
from ...utils.misc import scandir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True, help='image folder')
    p.add_argument('--crop_border', type=int, default=0)
    args = p.parse_args(argv)

    scores = []
    for i, rel in enumerate(sorted(scandir(args.input, recursive=True))):
        img = cv2.imread(osp.join(args.input, rel), cv2.IMREAD_UNCHANGED)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', category=RuntimeWarning)
            score = calculate_niqe(img, crop_border=args.crop_border)
        print(f'{i + 1:3d} {osp.basename(rel):25} NIQE: {score:.6f}')
        scores.append(score)
    if scores:
        print(f'Average NIQE: {np.mean(scores):.6f}')
    return scores


if __name__ == '__main__':
    main()
