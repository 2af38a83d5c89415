"""AlexNet-LPIPS between a restored folder and a GT folder (counterpart of
``scripts/metrics/calculate_lpips.py``; reference:
scripts/metrics/calculate_lpips.py).

    python -m basicsr4rs_torch.scripts.metrics.calculate_lpips --gt <dir> --restored <dir> \\
        --alexnet_weights alexnet-owt.pth --lin_weights lpips_alex_v0.1.pth [--device cpu]

The weights are torchvision's AlexNet file and the ``lpips`` package's
linear heads (``metrics/lpips.py``; without them the script raises). Each
GT image ``<name>.*`` is compared with ``<restored>/<name><suffix>.png``, both
read as RGB in [-1, 1]. Runs on the first card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from os import path as osp

import cv2
import numpy as np
import torch

from ...inference.inference_esrgan import inference_device
from ...metrics.lpips import LPIPS, load_lpips_weights
from ...utils.misc import scandir


def rgb11(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """(1, 3, H, W) float32 RGB in [-1, 1] of a BGR uint8 image."""
    rgb = img[..., ::-1].astype(np.float32) / 255. * 2 - 1
    return torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1)))[None].to(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--gt', required=True)
    p.add_argument('--restored', required=True)
    p.add_argument('--suffix', default='')
    p.add_argument('--alexnet_weights', default=None)
    p.add_argument('--lin_weights', default=None)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = inference_device(args.device)
    net = load_lpips_weights(LPIPS(), args.alexnet_weights, args.lin_weights).to(device).eval()
    scores = []
    for i, rel in enumerate(sorted(scandir(args.gt, recursive=True))):
        base = osp.splitext(osp.basename(rel))[0]
        gt = cv2.imread(osp.join(args.gt, rel), cv2.IMREAD_COLOR)
        restored = cv2.imread(osp.join(args.restored, base + args.suffix + '.png'),
                              cv2.IMREAD_COLOR)
        if restored is None:
            continue
        with torch.inference_mode():
            score = float(net(rgb11(gt, device), rgb11(restored, device))[0])
        print(f'{i + 1:3d} {base:25} LPIPS: {score:.6f}')
        scores.append(score)
    if scores:
        print(f'Average LPIPS: {np.mean(scores):.6f}')
    return scores


if __name__ == '__main__':
    main()
