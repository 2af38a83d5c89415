"""The official RIDNet checkpoint to a BasicSR ``.pth`` (counterpart of
``scripts/model_conversion/convert_ridnet.py``; reference:
scripts/model_conversion/convert_ridnet.py).

    python -m basicsr4rs_torch.scripts.model_conversion.convert_ridnet \
        --input RIDNet_official_original.pt --output experiments/pretrained_models/RIDNet.pth

The official tensors are given BasicSR's names by position, in the order of
``RIDNet(3, 64, 3).named_parameters()``.
"""

from __future__ import annotations

import argparse

from . import zoo_remaps
from .convert_models import load_official, save_params

_HEAD = ['sub_mean', 'add_mean', 'head']
_TAIL = ['tail']


def basicsr_ridnet_param_order(num_block: int = 4):
    """BasicSR ``RIDNet``'s parameter names in definition order."""
    names = [f'{m}.{p}' for m in _HEAD for p in ('weight', 'bias')]
    for b in range(num_block):
        eam = f'body.{b}'
        seqs = [f'{eam}.merge.dilation1.0', f'{eam}.merge.dilation1.2',
                f'{eam}.merge.dilation2.0', f'{eam}.merge.dilation2.2',
                f'{eam}.merge.aggregation.0',
                f'{eam}.block1.conv1', f'{eam}.block1.conv2',
                f'{eam}.block2.body.0', f'{eam}.block2.body.2', f'{eam}.block2.body.4',
                f'{eam}.ca.attention.1', f'{eam}.ca.attention.3']
        names += [f'{s}.{p}' for s in seqs for p in ('weight', 'bias')]
    names += [f'{m}.{p}' for m in _TAIL for p in ('weight', 'bias')]
    return names


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--input', required=True)
    p.add_argument('--output', required=True, help='output .pth file')
    args = p.parse_args(argv)

    state = zoo_remaps.remap_ridnet_positional(load_official(args.input),
                                               basicsr_ridnet_param_order())
    n = save_params(state, args.output)
    print(f'converted {n} tensors: {args.input} -> {args.output}')


if __name__ == '__main__':
    main()
