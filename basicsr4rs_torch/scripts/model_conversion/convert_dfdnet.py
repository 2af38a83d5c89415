"""The official DFDNet checkpoint to a BasicSR ``.pth`` (counterpart of
``scripts/model_conversion/convert_dfdnet.py``; reference:
scripts/model_conversion/convert_dfdnet.py).

    python -m basicsr4rs_torch.scripts.model_conversion.convert_dfdnet \
        --input DFDNet_official_original.pth --output experiments/pretrained_models/DFDNet.pth

Keys by ``zoo_remaps.remap_dfdnet`` with VGG19's layer names, so the VGG's
``features.<i>`` become BasicSR's ``conv<b>_<c>``; the output holds
``{'params': state_dict}``.
"""

from __future__ import annotations

import argparse
import functools

from ...archs.vgg_arch import vgg_layer_names
from . import zoo_remaps
from .convert_models import load_official, save_params


def convert(state):
    return zoo_remaps.remap_state_dict(
        state, functools.partial(zoo_remaps.remap_dfdnet, vgg_names=vgg_layer_names('vgg19')))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True)
    p.add_argument('--output', required=True, help='output .pth file')
    args = p.parse_args(argv)

    n = save_params(convert(load_official(args.input)), args.output)
    print(f'converted {n} tensors: {args.input} -> {args.output}')


if __name__ == '__main__':
    main()
