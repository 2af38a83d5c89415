"""Iterative back-projection refinement of SR outputs (counterpart of
``scripts/metrics/back_projection.py``; reference:
scripts/matlab_scripts/back_projection/{backprojection,main_bp,main_reverse_filter}.m),
on the port's MATLAB-parity bicubic ``imresize`` (``utils/matlab_functions.py``):

* ``bp`` mode: classic IBP. Downscale the current estimate, form the LR
  residual, upscale it and add it back through a squared-renormalised 5x5
  Gaussian (fspecial('gaussian', 5, 1).^2 / sum).
* ``if`` mode: reverse filtering. Add ``up(LR) - up(down(estimate))`` each
  iteration.

    python -m basicsr4rs_torch.scripts.metrics.back_projection --lr <LR dir> \\
        --pre <SR dir> --out <dir> [--mode bp|if] [--iters 20]
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2
import numpy as np

from ...utils.matlab_functions import imresize


def _bp_kernel() -> np.ndarray:
    """fspecial('gaussian', 5, 1) squared and renormalised."""
    ax = np.arange(5, dtype=np.float64) - 2
    g = np.exp(-(ax[:, None]**2 + ax[None, :]**2) / 2.0)
    g /= g.sum()
    g = g**2
    return g / g.sum()


def back_projection(im_h: np.ndarray, im_l: np.ndarray, max_iter: int = 20) -> np.ndarray:
    """IBP refinement (backprojection.m) of HWC float arrays in [0, 1]."""
    im_h = im_h.astype(np.float64)
    im_l = im_l.astype(np.float64)
    row_l, row_h = im_l.shape[0], im_h.shape[0]
    if row_h % row_l:
        raise ValueError(f'HR size {row_h} not an integer multiple of LR {row_l}')
    scale = row_h // row_l
    p = _bp_kernel()
    for _ in range(max_iter):
        im_l_s = imresize(im_h, 1.0 / scale)
        im_diff = imresize(im_l - im_l_s, float(scale))
        for ch in range(im_h.shape[2]):
            im_h[:, :, ch] += cv2.filter2D(im_diff[:, :, ch], -1, p,
                                           borderType=cv2.BORDER_CONSTANT)
    return im_h


def reverse_filter(im_h: np.ndarray, im_l: np.ndarray, max_iter: int = 20) -> np.ndarray:
    """Reverse-filter refinement (main_reverse_filter.m)."""
    im_h = im_h.astype(np.float64)
    scale = im_h.shape[0] // im_l.shape[0]
    j = imresize(im_l.astype(np.float64), float(scale))
    for _ in range(max_iter):
        im_h = im_h + (j - imresize(imresize(im_h, 1.0 / scale), float(scale)))
    return im_h


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--lr', required=True, help='LR input folder')
    parser.add_argument('--pre', required=True, help='pre-refinement SR output folder')
    parser.add_argument('--out', required=True, help='destination folder')
    parser.add_argument('--mode', choices=['bp', 'if'], default='bp')
    parser.add_argument('--iters', type=int, default=20)
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    refine = back_projection if args.mode == 'bp' else reverse_filter
    names = sorted(n for n in os.listdir(args.pre) if n.endswith('.png'))
    for i, name in enumerate(names):
        print(f'{i + 1}/{len(names)} {name}')
        im_l = cv2.imread(osp.join(args.lr, name)).astype(np.float64) / 255.
        im_h = cv2.imread(osp.join(args.pre, name)).astype(np.float64) / 255.
        out = refine(im_h, im_l, args.iters)
        cv2.imwrite(osp.join(args.out, name),
                    np.clip(np.round(out * 255.), 0, 255).astype(np.uint8))
    return names


if __name__ == '__main__':
    main()
