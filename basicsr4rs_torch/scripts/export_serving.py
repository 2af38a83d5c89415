"""Export a restoration network for serving ahead of time (counterpart of
``scripts/export_serving.py``).

Exports ``network_g`` of a test YAML once per input bucket with
``torch.export`` and writes a serving directory (``utils/serving.py``:
``manifest.json`` and one ``.pt2`` a bucket, the weights inside). The
artifacts need no model code to serve.

    python -m basicsr4rs_torch.scripts.export_serving \\
        -opt options/test/SRResNet_SRGAN/test_MSRResNet_x4.yml \\
        --model_path experiments/.../net_g_latest.pth \\
        --buckets 64x64,128x128,256x256 --out serving/msrresnet_x4

    # serve:
    from basicsr4rs_torch.utils.serving import ServingModel
    out = ServingModel('serving/msrresnet_x4').run(lq_nchw)

Exports on the first card unless ``--device cpu`` is given; an artifact
serves on the device it was exported on.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..archs import build_network
from ..inference.inference_swinir import load_weights
from ..ops.quant import calibrate_act_scales
from ..utils.options import yaml_load
from ..utils.serving import DTYPES, save_serving_dir, serving_device


def parse_buckets(text: str):
    """[(H, W), ...] of a comma-separated list of HxW."""
    buckets = []
    for tok in text.split(','):
        h, w = tok.lower().split('x')
        buckets.append((int(h), int(w)))
    return buckets


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-opt', required=True, help='test YAML naming network_g')
    p.add_argument('--model_path', default=None, help='.pth (default: random weights)')
    p.add_argument('--buckets', default='64x64,128x128,256x256',
                   help='comma-separated HxW input buckets')
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--out', required=True, help='output serving directory')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu': where the artifacts are exported and served")
    p.add_argument('--dtype', default='float32', choices=sorted(DTYPES))
    p.add_argument('--int8', action='store_true',
                   help='bake the W8A8 int8 serving mode into the artifact '
                        '(ops/quant.py; static activation scales)')
    p.add_argument('--calib', default=None,
                   help='NCHW .npy batch for int8 calibration (default: uniform random at '
                        'the first bucket shape)')
    args = p.parse_args(argv)

    device = serving_device(args.device)
    opt = yaml_load(args.opt)
    net_opt = dict(opt['network_g'])
    in_chans = net_opt.get('in_chans', net_opt.get('num_in_ch', 3))
    scale = int(opt.get('scale', net_opt.get('upscale', net_opt.get('scale', 1))))
    pad_multiple = int(net_opt.get('window_size', 1))
    buckets = parse_buckets(args.buckets)
    dtype = DTYPES[args.dtype]

    torch.manual_seed(0)
    net = build_network(net_opt)
    if args.model_path:
        load_weights(net, args.model_path)
    else:
        print('WARNING: no --model_path; exporting RANDOM weights')
    net = net.to(device=device, dtype=dtype).eval()

    scales = None
    if args.int8:
        if args.calib:
            calib = torch.from_numpy(np.load(args.calib))
        else:
            print('WARNING: no --calib; calibrating int8 scales on uniform random input')
            calib = torch.rand(args.batch, in_chans, *buckets[0],
                               generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            scales = calibrate_act_scales(net, net, [calib.to(device=device, dtype=dtype)])
        print(f'int8: calibrated {len(scales)} conv sites')

    manifest = save_serving_dir(
        args.out, net, buckets, scale=scale, in_chans=in_chans, batch=args.batch, dtype=dtype,
        pad_multiple=pad_multiple, device=device, quant_act_scales=scales,
        meta={'network': net_opt.get('type'), 'opt': args.opt})
    print(f'exported {len(manifest["buckets"])} buckets -> {args.out}')
    return manifest


if __name__ == '__main__':
    main()
