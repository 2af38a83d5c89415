"""HiFaceGAN pairs: each face image and a degraded copy (counterpart of
``scripts/data_preparation/prepare_hifacegan_dataset.py``; reference:
scripts/data_preparation/prepare_hifacegan_dataset.py, there on ``imgaug``,
here on numpy and cv2 as in the JAX package).

    python -m basicsr4rs_torch.scripts.data_preparation.prepare_hifacegan_dataset \
        --input datasets/ffhq_512 --output datasets/hifacegan [--deg full] [--seed 0]

Degradations (the HiFaceGAN paper's settings):
  sr4x      area-downsample x0.25, then bicubic back to the input size
  sr4x8x    area-downsample by a random factor in [0.125, 0.25], bicubic back
  mosaic    16x16 block-mean mosaic
  denoise   additive Gaussian / Laplace / Poisson noise (one drawn)
  dejpeg    JPEG at a quality drawn in [10, 40)
  full      each of the above in a random order, each with probability 0.5

Writes ``<output>/gt/<name>`` and ``<output>/lq_<deg>/<name>``; every draw
comes from one ``RandomState(seed)``, image by image in sorted order.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2
import numpy as np


def deg_sr4x(img, rng):
    h, w = img.shape[:2]
    small = cv2.resize(img, None, fx=0.25, fy=0.25, interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def deg_sr4x8x(img, rng):
    h, w = img.shape[:2]
    f = rng.uniform(0.125, 0.25)
    small = cv2.resize(img, None, fx=f, fy=f, interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def deg_mosaic(img, rng):
    x = img.astype(np.float64)
    h, w = x.shape[:2]
    for i in range((h + 15) // 16):
        for j in range((w + 15) // 16):
            block = x[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16]
            block[...] = block.mean(axis=(0, 1))
    return np.clip(x, 0, 255).astype(np.uint8)


def deg_denoise(img, rng):
    kind = rng.randint(3)
    x = img.astype(np.float64)
    if kind == 0:     # Gaussian
        x = x + rng.normal(0, rng.uniform(20, 40), img.shape)
    elif kind == 1:   # Laplace
        x = x + rng.laplace(0, rng.uniform(20, 40) / np.sqrt(2), img.shape)
    else:             # Poisson, centred by a second draw (imgaug's convention)
        x = x + rng.poisson(rng.uniform(15, 30), img.shape) - rng.uniform(15, 30)
    return np.clip(x, 0, 255).astype(np.uint8)


def deg_dejpeg(img, rng):
    q = int(rng.uniform(10, 40))
    _, enc = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


DEGRADATIONS = {
    'sr4x': deg_sr4x,
    'sr4x8x': deg_sr4x8x,
    'mosaic': deg_mosaic,
    'denoise': deg_denoise,
    'dejpeg': deg_dejpeg,
}


def deg_full(img, rng):
    out = img
    for name in rng.permutation(sorted(DEGRADATIONS)):
        if rng.rand() < 0.5:
            out = DEGRADATIONS[name](out, rng)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--input', required=True, help='512x512 GT face folder')
    p.add_argument('--output', required=True)
    p.add_argument('--deg', choices=sorted(DEGRADATIONS) + ['full'], default='full')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    fn = deg_full if args.deg == 'full' else DEGRADATIONS[args.deg]
    lq_dir = osp.join(args.output, f'lq_{args.deg}')
    gt_dir = osp.join(args.output, 'gt')
    os.makedirs(lq_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)

    names = sorted(os.listdir(args.input))
    for idx, name in enumerate(names):
        img = cv2.imread(osp.join(args.input, name), cv2.IMREAD_COLOR)
        if img is None:
            continue
        cv2.imwrite(osp.join(gt_dir, name), img)
        cv2.imwrite(osp.join(lq_dir, name), fn(img, rng))
        if idx % 100 == 0:
            print(f'{idx}/{len(names)}', flush=True)
    print('done')


if __name__ == '__main__':
    main()
