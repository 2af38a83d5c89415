"""BasicVSR x4 inference on a folder of frames (counterpart of the JAX
package's ``inference/inference_basicvsr.py``; reference:
inference/inference_basicvsr.py).

    python -m basicsr4rs_torch.inference.inference_basicvsr --model_path net_g.pth \
        --input datasets/REDS4/000 --output results/BasicVSR [--interval 15]

The frames of ``--input`` (sorted by name) go through the network in
chunks of ``--interval`` frames, each chunk one clip; each output frame is
written as ``<name>_BasicVSR.png``. The ``.pth`` holds ``params_ema`` (else
``params``, else a bare state_dict) of a ``BasicVSR`` with ``--num_feat``
features and ``--num_block`` blocks. Runs on the first CUDA device unless
``--device cpu`` is given; with no card and no such argument it raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from os import path as osp

import cv2
import numpy as np
import torch
from torch import nn

from ..archs.basicvsr_arch import BasicVSR
from .inference_esrgan import inference_device
from .inference_swinir import load_state_dict


def read_clip(folder: str, device: torch.device):
    """(1, T, 3, H, W) float32 RGB in [0, 1] of the frames of ``folder``
    (sorted by name), and the frames' names without extension."""
    paths = sorted(glob.glob(osp.join(folder, '*')))
    frames = [cv2.imread(p, cv2.IMREAD_COLOR).astype(np.float32)[..., ::-1] / 255. for p in paths]
    clip = torch.from_numpy(np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2)))
    return clip[None].to(device), [osp.splitext(osp.basename(p))[0] for p in paths]


def write_frames(out: torch.Tensor, names, folder: str, suffix: str) -> None:
    """Write (T, 3, H, W) RGB in [0, 1] as 8-bit ``<name>_<suffix>.png``."""
    frames = (out.clamp(0, 1).permute(0, 2, 3, 1).cpu().numpy()[..., ::-1] * 255.).round()
    for img, name in zip(frames.astype(np.uint8), names):
        cv2.imwrite(osp.join(folder, f'{name}_{suffix}.png'), img)


def run_clip(net: nn.Module, args, suffix: str) -> None:
    """``net`` on the frames of ``args.input`` in chunks of ``args.interval``."""
    device = inference_device(args.device)
    net.load_state_dict(load_state_dict(args.model_path), strict=True)
    net.to(device).eval()
    clip, names = read_clip(args.input, device)
    os.makedirs(args.output, exist_ok=True)
    for start in range(0, clip.shape[1], args.interval):
        with torch.inference_mode():
            out = net(clip[:, start:start + args.interval])[0]
        write_frames(out, names[start:start + args.interval], args.output, suffix)
        print('\n'.join(names[start:start + args.interval]))


def parser(output: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--input', default='datasets/REDS4/000', help='input frame folder')
    p.add_argument('--output', default=output, help='output folder')
    p.add_argument('--interval', type=int, default=15, help='frames a forward')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    p = parser('results/BasicVSR')
    p.add_argument('--num_feat', type=int, default=64)
    p.add_argument('--num_block', type=int, default=30)
    args = p.parse_args(argv)
    run_clip(BasicVSR(num_feat=args.num_feat, num_block=args.num_block), args, 'BasicVSR')


if __name__ == '__main__':
    main()
