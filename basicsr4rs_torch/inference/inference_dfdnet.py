"""DFDNet face restoration (counterpart of the JAX package's
``inference/inference_dfdnet.py``; reference: inference/inference_dfdnet.py).

    python -m basicsr4rs_torch.inference.inference_dfdnet --model_path net.pth \
        --dict_path dict.pth --input faces --locations boxes.txt --output results/dfdnet

``--input`` holds 512x512 aligned faces; ``--locations`` a line a face:
its file name and the boxes ``x0 y0 x1 y1`` of the left eye, the right eye,
the nose and the mouth (16 numbers; the reference finds them with dlib,
which is not bundled). ``--model_path``: ``params_ema`` (else ``params``)
of a ``DFDNet`` of ``--num_feat``; ``--dict_path``: the component
dictionary. Runs on the first CUDA device unless ``--device cpu`` is given;
with no card and no such argument it raises.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

import cv2
import numpy as np
import torch

from ..archs.dfdnet_arch import DFDNet, load_dfdnet_dict
from .inference_esrgan import inference_device
from .inference_swinir import load_weights


def read_locations(path: str):
    """{name: (4, 4) boxes} of a locations file."""
    locs = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 17:
                locs[parts[0]] = np.asarray([float(v) for v in parts[1:]]).reshape(4, 4)
    return locs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--dict_path', required=True)
    p.add_argument('--input', required=True, help='512x512 aligned face folder')
    p.add_argument('--locations', required=True,
                   help='txt: name x0 y0 x1 y1 (left_eye) ... for 4 parts')
    p.add_argument('--output', default='results/dfdnet')
    p.add_argument('--num_feat', type=int, default=64)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = DFDNet(num_feat=args.num_feat)
    load_weights(net, args.model_path)
    net.to(device).eval()
    dictionary = {size: {part: torch.from_numpy(v).to(device) for part, v in parts.items()}
                  for size, parts in load_dfdnet_dict(args.dict_path).items()}

    os.makedirs(args.output, exist_ok=True)
    for name, boxes in read_locations(args.locations).items():
        img = cv2.imread(osp.join(args.input, name), cv2.IMREAD_COLOR)
        if img is None:
            print(f'skip {name}')
            continue
        x = img[..., ::-1].astype(np.float32) / 255. * 2 - 1
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))[None].to(device)
        with torch.inference_mode():
            out = net(x, [boxes[i:i + 1] for i in range(4)], dictionary)
        out = ((out[0].clamp(-1, 1) + 1) / 2).permute(1, 2, 0).cpu().numpy()[..., ::-1]
        cv2.imwrite(osp.join(args.output, name), (out * 255).round().astype(np.uint8))
        print(name)


if __name__ == '__main__':
    main()
