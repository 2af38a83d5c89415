"""Inception statistics (mean, covariance) of a folder of images
(counterpart of ``scripts/metrics/calculate_fid_stats_from_datasets.py``;
reference: scripts/metrics/calculate_fid_stats_from_datasets.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_fid_stats_from_datasets \
        --folder datasets/ffhq --output inception_ffhq.npz [--size 299]

Writes ``mean`` and ``cov`` to ``--output``, the file that
``calculate_fid_folder`` and ``calculate_stylegan2_fid`` read. Runs on the
first CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from ...inference.inference_esrgan import inference_device
from ...metrics.fid import calculate_stats, extract_inception_features, load_patched_inception_v3
from .calculate_fid_folder import folder_batches


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--folder', required=True)
    p.add_argument('--output', required=True, help='output npz path')
    p.add_argument('--inception_weights', default=None)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--size', type=int, default=299)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    inception = load_patched_inception_v3(args.inception_weights,
                                          device=inference_device(args.device))
    feats = extract_inception_features(
        folder_batches(args.folder, args.batch_size, args.size), inception)
    mu, sigma = calculate_stats(feats)
    np.savez(args.output, mean=mu, cov=sigma)
    print(f'saved stats for {feats.shape[0]} images to {args.output}')


if __name__ == '__main__':
    main()
