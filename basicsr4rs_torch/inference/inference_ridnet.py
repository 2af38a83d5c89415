"""RIDNet denoising on a folder of images (counterpart of the JAX package's
``inference/inference_ridnet.py``; reference: inference/inference_ridnet.py).

    python -m basicsr4rs_torch.inference.inference_ridnet --model_path net_g.pth \
        --input datasets/denoise --output results/ridnet

The ``.pth`` holds ``params_ema`` (else ``params``, else a bare state_dict)
of a ``RIDNet`` with 64 features. Runs on the first CUDA device unless
``--device cpu`` is given; with no card and no such argument it raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from os import path as osp

import torch

from ..archs.ridnet_arch import RIDNet
from .inference_esrgan import inference_device, read_rgb, write_rgb
from .inference_swinir import load_state_dict


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--input', default='datasets/denoise', help='noisy image folder')
    p.add_argument('--output', default='results/ridnet')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = RIDNet(in_channels=3, mid_channels=64, out_channels=3)
    net.load_state_dict(load_state_dict(args.model_path), strict=True)
    net.to(device).eval()

    os.makedirs(args.output, exist_ok=True)
    for idx, path in enumerate(sorted(glob.glob(osp.join(args.input, '*')))):
        name = osp.splitext(osp.basename(path))[0]
        print(f'{idx:3d} {name}')
        with torch.inference_mode():
            out = net(read_rgb(path, device))
        write_rgb(out, osp.join(args.output, f'{name}_RIDNet.png'))


if __name__ == '__main__':
    main()
