"""SwinIR inference on a folder of images, with window padding and batched
tiling (counterpart of the JAX package's ``inference/inference_swinir.py``;
reference: inference/inference_swinir.py, task presets included).

    python -m basicsr4rs_torch.inference.inference_swinir --model_path net.pth \
        --task classical_sr --input datasets/lq --output results/swinir [--tile 128]

Runs on the first CUDA device unless ``--device cpu`` is given; with no card
and no such argument it raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import OrderedDict
from os import path as osp

import cv2
import numpy as np
import torch

from ..archs.swinir_arch import SwinIR
from ..models.base_model import _COMPUTED_BUFFERS
from ..models.swinir_model import pad_to_multiple
from ..ops.tile import tiled_apply

TASKS = {
    'classical_sr': dict(upscale=4, in_chans=3, img_size=48, window_size=8,
                         img_range=1., depths=[6] * 6, embed_dim=180,
                         num_heads=[6] * 6, mlp_ratio=2, upsampler='pixelshuffle'),
    'lightweight_sr': dict(upscale=4, in_chans=3, img_size=64, window_size=8,
                           img_range=1., depths=[6] * 4, embed_dim=60,
                           num_heads=[6] * 4, mlp_ratio=2, upsampler='pixelshuffledirect'),
    'real_sr': dict(upscale=4, in_chans=3, img_size=64, window_size=8,
                    img_range=1., depths=[6] * 6, embed_dim=180,
                    num_heads=[6] * 6, mlp_ratio=2, upsampler='nearest+conv'),
    'gray_dn': dict(upscale=1, in_chans=1, img_size=128, window_size=8,
                    img_range=1., depths=[6] * 6, embed_dim=180,
                    num_heads=[6] * 6, mlp_ratio=2, upsampler=''),
    'color_dn': dict(upscale=1, in_chans=3, img_size=128, window_size=8,
                     img_range=1., depths=[6] * 6, embed_dim=180,
                     num_heads=[6] * 6, mlp_ratio=2, upsampler=''),
    'jpeg_car': dict(upscale=1, in_chans=1, img_size=126, window_size=7,
                     img_range=255., depths=[6] * 6, embed_dim=180,
                     num_heads=[6] * 6, mlp_ratio=2, upsampler=''),
}


def load_state_dict(model_path: str) -> 'OrderedDict[str, torch.Tensor]':
    """The ``params_ema`` (else ``params``, else bare) state_dict of a
    ``.pth``, without ``module.`` prefixes and the buffers the port computes."""
    ckpt = torch.load(model_path, map_location='cpu', weights_only=True)
    for key in ('params_ema', 'params'):
        if key in ckpt:
            ckpt = ckpt[key]
            break
    return OrderedDict((k[len('module.'):] if k.startswith('module.') else k, v)
                       for k, v in ckpt.items() if not k.endswith(_COMPUTED_BUFFERS))


def load_weights(net: torch.nn.Module, model_path: str) -> None:
    """``load_state_dict`` of ``model_path`` into ``net``, strictly, less the
    keys of the network's non-persistent buffers (constants the port makes
    itself, such as resampling kernels, which BasicSR's files store)."""
    constants = {k for k, _ in net.named_buffers()} - set(net.state_dict())
    net.load_state_dict(OrderedDict((k, v) for k, v in load_state_dict(model_path).items()
                                    if k not in constants), strict=True)


def round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def build_apply(net: SwinIR, scale: int, window: int, tile: int = 0, tile_pad: int = 32):
    """``x -> net(x)`` under inference mode, tiled when ``tile`` > 0 with
    the tile and its pad rounded up to the window, so that every padded tile
    stays a window multiple. All tiles run as one batch."""
    def forward(x):
        with torch.inference_mode():
            return net(x)
    if not tile:
        return forward
    tile, pad = round_up(tile, window), round_up(tile_pad, window)
    return lambda x: tiled_apply(forward, x, scale, tile, pad)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_path', required=True)
    p.add_argument('--task', choices=sorted(TASKS), default='classical_sr')
    p.add_argument('--scale', type=int, default=None, help='override task upscale')
    p.add_argument('--input', default='datasets/lq')
    p.add_argument('--output', default='results/swinir')
    p.add_argument('--tile', type=int, default=0,
                   help='tile size for batched tiled inference on huge inputs (0 = whole '
                        'image; rounded up to the window multiple). Tiles run as ONE batch.')
    p.add_argument('--tile_pad', type=int, default=32,
                   help='halo around each tile core (input pixels)')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('inference_swinir: no CUDA device; pass --device cpu to run on the CPU')
    kwargs = dict(TASKS[args.task])
    if args.scale is not None:
        kwargs['upscale'] = args.scale
    net = SwinIR(**kwargs)
    net.load_state_dict(load_state_dict(args.model_path), strict=True)
    net.to(device).eval()
    scale, window = kwargs['upscale'], kwargs['window_size']
    apply = build_apply(net, scale, window, args.tile, args.tile_pad)
    gray = kwargs['in_chans'] == 1

    os.makedirs(args.output, exist_ok=True)
    for idx, path in enumerate(sorted(glob.glob(osp.join(args.input, '*')))):
        name = osp.splitext(osp.basename(path))[0]
        print(f'{idx:3d} {name}')
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        img = img.astype(np.float32) / 255.
        img = img[..., None] if gray else img[..., ::-1]
        x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None].to(device)
        h, w = x.shape[-2:]
        out = apply(pad_to_multiple(x, window))[0, :, :h * scale, :w * scale]
        out = out.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
        out = out[..., 0] if gray else out[..., ::-1]
        cv2.imwrite(osp.join(args.output, f'{name}_SwinIR.png'),
                    (out * 255).round().astype(np.uint8))


if __name__ == '__main__':
    main()
