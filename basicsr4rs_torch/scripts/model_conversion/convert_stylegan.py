"""Official stylegan2-pytorch (rosinality) weights to BasicSR ``.pth`` files
(counterpart of ``scripts/model_conversion/convert_stylegan.py``; reference:
scripts/model_conversion/convert_stylegan.py).

    python -m basicsr4rs_torch.scripts.model_conversion.convert_stylegan \
        --input stylegan2-ffhq.pth --output_g stylegan2_g.pth [--output_d stylegan2_d.pth]

The official file holds ``g_ema``, ``g``, ``d`` and ``latent_avg``: the EMA
generator (else ``g``, else the file itself) goes to ``--output_g``, the
discriminator to ``--output_d``, each as ``{'params': state_dict}``.
"""

from __future__ import annotations

import argparse

import torch

from . import zoo_remaps
from .convert_models import save_params


def convert_generator(g_src):
    return zoo_remaps.remap_state_dict(
        g_src, lambda k: zoo_remaps.remap_stylegan2_g(k, tuple(g_src[k].shape)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True)
    p.add_argument('--output_g', required=True, help='output .pth of the generator')
    p.add_argument('--output_d', default=None, help='output .pth of the discriminator')
    args = p.parse_args(argv)

    blob = torch.load(args.input, map_location='cpu', weights_only=False)
    n = save_params(convert_generator(blob.get('g_ema', blob.get('g', blob))), args.output_g)
    print(f'generator: converted {n} tensors -> {args.output_g}')
    if args.output_d and 'd' in blob:
        d = zoo_remaps.remap_state_dict(blob['d'], zoo_remaps.remap_stylegan2_d)
        n = save_params(d, args.output_d)
        print(f'discriminator: converted {n} tensors -> {args.output_d}')


if __name__ == '__main__':
    main()
