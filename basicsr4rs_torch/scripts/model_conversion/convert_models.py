"""Official EDSR, RCAN, ESRGAN, EDVR and DUF checkpoints to BasicSR ``.pth``
files (counterpart of ``scripts/model_conversion/convert_models.py``;
reference: scripts/model_conversion/convert_models.py).

    python -m basicsr4rs_torch.scripts.model_conversion.convert_models --model edsr \
        --input EDSR_x4.pt --output experiments/pretrained_models/EDSR_Lx4.pth --num_block 32

The output holds ``{'params': state_dict}`` under BasicSR's names, which the
port's ``load_network`` reads as is. RIDNet, StyleGAN2 and DFDNet have
scripts of their own beside this one.
"""

from __future__ import annotations

import argparse
import functools

import torch

from . import zoo_remaps

ARCH_FOR_MODEL = {'edsr': 'EDSR', 'rcan': 'RCAN', 'esrgan': 'RRDBNet',
                  'edvr': 'EDVR', 'duf': 'DUF'}


def load_official(path):
    """An official checkpoint's state dict: the file itself, or its
    ``params``, ``params_ema``, ``state_dict`` or ``model`` entry."""
    state = torch.load(path, map_location='cpu', weights_only=False)
    for key in ('params', 'params_ema', 'state_dict', 'model'):
        if isinstance(state, dict) and key in state and isinstance(state[key], dict):
            state = state[key]
            break
    return state


def save_params(state, output):
    """Write ``{'params': state}`` to ``output``; returns the tensor count."""
    torch.save({'params': dict(state)}, output)
    return len(state)


def convert(state, model, num_block=32, num_group=10, rcan_num_block=20, scale=4):
    """The state dict of an official ``model`` checkpoint under BasicSR's
    names."""
    if model == 'edsr':
        key_fn = functools.partial(zoo_remaps.remap_edsr, num_block=num_block)
    elif model == 'rcan':
        key_fn = functools.partial(zoo_remaps.remap_rcan, num_group=num_group,
                                   num_block=rcan_num_block)
    elif model == 'esrgan':
        key_fn = zoo_remaps.remap_esrgan_rrdb
    elif model == 'edvr':
        key_fn = zoo_remaps.remap_edvr
    else:
        key_fn = zoo_remaps.remap_duf_16l
    remapped = zoo_remaps.remap_state_dict(state, key_fn)
    if model == 'duf':
        remapped['conv3d_r2.weight'], remapped['conv3d_r2.bias'] = zoo_remaps.reorder_duf_r2(
            remapped['conv3d_r2.weight'], remapped['conv3d_r2.bias'], scale)
    return remapped


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model', required=True, choices=sorted(ARCH_FOR_MODEL))
    p.add_argument('--input', required=True, help='official checkpoint (.pt/.pth)')
    p.add_argument('--output', required=True, help='output .pth file')
    p.add_argument('--num_block', type=int, default=32,
                   help='EDSR residual blocks (32 for L, 16 for M)')
    p.add_argument('--num_group', type=int, default=10, help='RCAN groups')
    p.add_argument('--rcan_num_block', type=int, default=20, help='RCAN blocks/group')
    p.add_argument('--scale', type=int, default=4, help='DUF upscale (channel regroup)')
    args = p.parse_args(argv)

    state = convert(load_official(args.input), args.model, args.num_block, args.num_group,
                    args.rcan_num_block, args.scale)
    n = save_params(state, args.output)
    print(f'converted {n} tensors for {ARCH_FOR_MODEL[args.model]}: '
          f'{args.input} -> {args.output}')


if __name__ == '__main__':
    main()
