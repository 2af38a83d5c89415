"""FID of a StyleGAN2 generator against dataset statistics (counterpart of
``scripts/metrics/calculate_stylegan2_fid.py``; reference:
scripts/metrics/calculate_stylegan2_fid.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_stylegan2_fid \
        --ckpt net_g.pth --fid_stats inception_FFHQ_256.npz --out_size 256

Samples ``--num_sample`` images of the ``.pth``'s ``params_ema`` (else
``params``) generator (512 style features, channel multiplier 2), codes and
noise from a generator seeded by ``--seed``, maps them from [-1, 1] to
[0, 1] and scores their Inception features. Runs on the first CUDA device
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ...archs.stylegan2_arch import StyleGAN2Generator
from ...inference.inference_esrgan import inference_device
from ...inference.inference_swinir import load_weights
from ...metrics.fid import (calculate_fid, calculate_stats, extract_inception_features,
                            load_patched_inception_v3)


def sample_batches(net: StyleGAN2Generator, num_sample: int, batch_size: int,
                   generator: torch.Generator):
    """``ceil(num_sample / batch_size)`` batches of samples in [0, 1]."""
    device = generator.device
    for _ in range(math.ceil(num_sample / batch_size)):
        z = torch.randn((batch_size, net.num_style_feat), generator=generator, device=device)
        with torch.inference_mode():
            img, _ = net([z], generator=generator)
        yield ((img + 1) / 2).clamp(0., 1.)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ckpt', required=True, help='generator checkpoint (.pth)')
    p.add_argument('--fid_stats', required=True)
    p.add_argument('--out_size', type=int, default=256)
    p.add_argument('--num_sample', type=int, default=50000)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--inception_weights', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = StyleGAN2Generator(out_size=args.out_size)
    load_weights(net, args.ckpt)
    net.to(device).eval()
    inception = load_patched_inception_v3(args.inception_weights, device=device)
    generator = torch.Generator(device).manual_seed(args.seed)
    feats = extract_inception_features(
        sample_batches(net, args.num_sample, args.batch_size, generator), inception)
    mu, sigma = calculate_stats(feats[:args.num_sample])
    stats = np.load(args.fid_stats)
    fid = calculate_fid(mu, sigma, stats['mean'], stats['cov'])
    print(f'fid: {fid:.6f}')
    return fid


if __name__ == '__main__':
    main()
