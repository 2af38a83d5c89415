"""FID between a folder of images and precomputed dataset statistics
(counterpart of ``scripts/metrics/calculate_fid_folder.py``; reference:
scripts/metrics/calculate_fid_folder.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_fid_folder --folder results/x \
        --fid_stats inception_FFHQ_256.npz [--inception_weights pt_inception-....pth]

Every image under ``--folder`` (recursively, sorted) is resized to 299x299
by bicubic interpolation; the statistics file holds ``mean`` and ``cov``.
Runs on the first CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from os import path as osp

import cv2
import numpy as np

from ...inference.inference_esrgan import inference_device
from ...metrics.fid import (calculate_fid, calculate_stats, extract_inception_features,
                            load_patched_inception_v3)
from ...utils.misc import scandir


def folder_batches(folder: str, batch_size: int, size: int = 299):
    """NCHW float32 RGB batches in [0, 1] of the folder's images, each
    resized to ``size`` x ``size`` (bicubic)."""
    batch = []
    for rel in sorted(scandir(folder, recursive=True)):
        img = cv2.imread(osp.join(folder, rel), cv2.IMREAD_COLOR)
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
        batch.append(img[..., ::-1].transpose(2, 0, 1).astype(np.float32) / 255.)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--folder', required=True)
    p.add_argument('--fid_stats', required=True, help='npz with mean/cov of the dataset')
    p.add_argument('--inception_weights', default=None)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    inception = load_patched_inception_v3(args.inception_weights,
                                          device=inference_device(args.device))
    feats = extract_inception_features(folder_batches(args.folder, args.batch_size), inception)
    mu, sigma = calculate_stats(feats)
    stats = np.load(args.fid_stats)
    fid = calculate_fid(mu, sigma, stats['mean'], stats['cov'])
    print(f'fid: {fid:.6f}')
    return fid


if __name__ == '__main__':
    main()
