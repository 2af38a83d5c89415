"""StyleGAN2 sampling with truncation (counterpart of the JAX package's
``inference/inference_stylegan2.py``; reference:
inference/inference_stylegan2.py).

    python -m basicsr4rs_torch.inference.inference_stylegan2 --model_path net_g.pth \
        --out_size 256 --truncation 0.7 --pics 4 --output samples

The ``.pth`` holds ``params_ema`` (else ``params``) of a
``StyleGAN2Generator`` (``--channel_multiplier``, 512 style features, 8
MLP layers). The truncation centre is the mean W of ``--truncation_mean``
codes through the style MLP. Codes and noise come from a generator seeded
by ``--seed``. Runs on the first CUDA device unless ``--device cpu`` is
given; with no card and no such argument it raises.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2
import numpy as np
import torch

from ..archs.stylegan2_arch import StyleGAN2Generator
from .inference_esrgan import inference_device
from .inference_swinir import load_weights


@torch.no_grad()
def mean_latent(net: StyleGAN2Generator, n: int, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """The mean W of ``n`` codes: the truncation centre."""
    z = torch.randn((n, net.num_style_feat), generator=generator, device=device)
    return net.style_mlp(z).mean(dim=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--out_size', type=int, default=1024)
    p.add_argument('--channel_multiplier', type=int, default=2)
    p.add_argument('--truncation', type=float, default=0.7)
    p.add_argument('--truncation_mean', type=int, default=4096)
    p.add_argument('--sample', type=int, default=1, help='images per batch')
    p.add_argument('--pics', type=int, default=20, help='number of batches')
    p.add_argument('--output', default='samples')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = StyleGAN2Generator(out_size=args.out_size, channel_multiplier=args.channel_multiplier)
    load_weights(net, args.model_path)
    net.to(device).eval()
    generator = torch.Generator(device).manual_seed(args.seed)
    center = (mean_latent(net, args.truncation_mean, generator, device)
              if args.truncation < 1 else None)

    os.makedirs(args.output, exist_ok=True)
    for i in range(args.pics):
        z = torch.randn((args.sample, net.num_style_feat), generator=generator, device=device)
        with torch.inference_mode():
            imgs, _ = net([z], truncation=args.truncation, truncation_latent=center,
                          generator=generator)
        imgs = ((imgs.clamp(-1, 1) + 1) / 2).permute(0, 2, 3, 1).cpu().numpy()
        for j, img in enumerate(imgs):
            cv2.imwrite(osp.join(args.output, f'{i * args.sample + j:06d}.png'),
                        (img[..., ::-1] * 255).round().astype(np.uint8))
        print(f'batch {i + 1}/{args.pics}')


if __name__ == '__main__':
    main()
