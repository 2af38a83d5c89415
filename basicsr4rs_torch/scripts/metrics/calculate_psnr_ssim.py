"""PSNR and SSIM between a restored folder and a GT folder (counterpart of
``scripts/metrics/calculate_psnr_ssim.py``; reference:
scripts/metrics/calculate_psnr_ssim.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_psnr_ssim --gt <dir> \\
        --restored <dir> [--crop_border 4] [--suffix _x4] [--test_y_channel]

Each GT image ``<name>.*`` is compared with ``<restored>/<name><suffix>.png``
by the port's host metrics (float64 numpy, as the validation's).
"""

from __future__ import annotations

import argparse
from os import path as osp

import cv2
import numpy as np

from ...metrics.psnr_ssim import calculate_psnr, calculate_ssim
from ...utils.misc import scandir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--gt', required=True, help='ground-truth folder')
    p.add_argument('--restored', required=True, help='restored image folder')
    p.add_argument('--crop_border', type=int, default=4)
    p.add_argument('--suffix', default='', help='suffix of restored files vs gt names')
    p.add_argument('--test_y_channel', action='store_true')
    args = p.parse_args(argv)

    psnrs, ssims = [], []
    for i, gt_rel in enumerate(sorted(scandir(args.gt, recursive=True))):
        base = osp.splitext(osp.basename(gt_rel))[0]
        gt = cv2.imread(osp.join(args.gt, gt_rel), cv2.IMREAD_UNCHANGED).astype(np.float64)
        restored_path = osp.join(args.restored, base + args.suffix + '.png')
        restored = cv2.imread(restored_path, cv2.IMREAD_UNCHANGED)
        if restored is None:
            print(f'skip {base}: no restored image at {restored_path}')
            continue
        restored = restored.astype(np.float64)
        psnr = calculate_psnr(restored, gt, crop_border=args.crop_border,
                              test_y_channel=args.test_y_channel)
        ssim = calculate_ssim(restored, gt, crop_border=args.crop_border,
                              test_y_channel=args.test_y_channel)
        print(f'{i + 1:3d} {base:25} PSNR: {psnr:.6f} dB, SSIM: {ssim:.6f}')
        psnrs.append(psnr)
        ssims.append(ssim)
    if psnrs:
        print(f'Average: PSNR: {np.mean(psnrs):.6f} dB, SSIM: {np.mean(ssims):.6f}')
    return psnrs, ssims


if __name__ == '__main__':
    main()
