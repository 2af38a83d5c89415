"""ESRGAN x4 inference on a folder of images, whole or in batched tiles
(counterpart of the JAX package's ``inference/inference_esrgan.py``;
reference: inference/inference_esrgan.py).

    python -m basicsr4rs_torch.inference.inference_esrgan --model_path net_g.pth \
        --input datasets/lq --output results/esrgan [--tile 128]

The ``.pth`` holds ``params_ema`` (else ``params``, else a bare state_dict)
of an ``RRDBNet`` with ``--num_feat`` features and ``--num_block`` blocks.
Runs on the first CUDA device unless ``--device cpu`` is given; with no card
and no such argument it raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from os import path as osp

import cv2
import numpy as np
import torch

from ..archs.rrdbnet_arch import RRDBNet
from ..ops.tile import tiled_apply
from .inference_swinir import load_state_dict


def inference_device(name: str) -> torch.device:
    """The device ``--device`` names; a CUDA one must be there."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass --device cpu to run on the CPU')
    return device


def read_rgb(path: str, device: torch.device) -> torch.Tensor:
    """(1, 3, H, W) float32 RGB in [0, 1] of an image file."""
    img = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float32) / 255.
    return torch.from_numpy(np.ascontiguousarray(img[..., ::-1].transpose(2, 0, 1)))[None].to(
        device)


def write_rgb(out: torch.Tensor, path: str) -> None:
    """Write (1, 3, H, W) RGB in [0, 1] as an 8-bit image."""
    img = out[0].clamp(0, 1).permute(1, 2, 0).cpu().numpy()[..., ::-1]
    cv2.imwrite(path, (img * 255).round().astype(np.uint8))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--input', default='datasets/lq', help='input folder')
    p.add_argument('--output', default='results/esrgan', help='output folder')
    p.add_argument('--num_feat', type=int, default=64)
    p.add_argument('--num_block', type=int, default=23)
    p.add_argument('--tile', type=int, default=0,
                   help='tile size for batched tiled inference (0 = whole image)')
    p.add_argument('--tile_pad', type=int, default=16)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=args.num_feat, num_block=args.num_block,
                  num_grow_ch=32)
    net.load_state_dict(load_state_dict(args.model_path), strict=True)
    net.to(device).eval()

    def forward(x):
        with torch.inference_mode():
            return net(x)

    os.makedirs(args.output, exist_ok=True)
    for idx, path in enumerate(sorted(glob.glob(osp.join(args.input, '*')))):
        name = osp.splitext(osp.basename(path))[0]
        print(f'{idx:3d} {name}')
        x = read_rgb(path, device)
        out = tiled_apply(forward, x, 4, args.tile, args.tile_pad) if args.tile else forward(x)
        write_rgb(out, osp.join(args.output, f'{name}_ESRGAN.png'))


if __name__ == '__main__':
    main()
