"""Parameters, FLOPs and FLOPs per output pixel of the port's networks
(counterpart of ``scripts/plot/model_complexity.py``; reference:
scripts/plot/model_complexity_cmp_bsrn.py).

    python -m basicsr4rs_torch.scripts.plot.model_complexity --lr-size 64 \
        "MSRResNet:{}" "EDSR:{num_block: 16}" \
        "SwinIR:{embed_dim: 60, depths: [6,6,6,6], num_heads: [6,6,6,6], window_size: 8, \
                 upsampler: pixelshuffledirect}" \
        [--scale 4] [--plot scatter.png]

Each positional argument is ``ArchName:{yaml kwargs}`` of any registered
arch; one JSON line per network, and with ``--plot`` a params-vs-FLOPs
scatter (matplotlib). The network is built on the meta device where it
builds there (no weights are made), else on the CPU, and one forward of a
1 x 3 x lr x lr input runs under ``torch.utils.flop_counter.FlopCounterMode``.

What is counted differs from the JAX package's script. There XLA's cost
analysis of the compiled forward counts every operation of the graph:
convolutions and matrix products at two per multiply-add, and also each
element of the adds, activations, normalisations, softmax and resampling.
``FlopCounterMode`` counts only the matrix products, convolutions and
attention (two per multiply-add): elementwise work, normalisations, softmax
and interpolation count nothing. On convolution-bound networks the two
agree within a few percent; on transformers the torch count is lower by the
softmax, LayerNorm and GELU work.
"""

from __future__ import annotations

import argparse
import json

import torch


def complexity(arch_opt, lr_size, scale=4):
    """(parameters, FLOPs) of one forward of a 1 x 3 x lr x lr input: on the
    meta device, or on the CPU where the network does not build or run
    there (a kernel wrapper refuses a meta tensor)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ...archs import build_network
    for device in ('meta', 'cpu'):
        try:
            with torch.device(device):
                net = build_network(dict(arch_opt)).eval()
            counter = FlopCounterMode(display=False)
            with torch.no_grad(), counter:
                net(torch.zeros(1, 3, lr_size, lr_size, device=device))
        except (NotImplementedError, RuntimeError, ValueError):
            if device == 'cpu':
                raise
            continue
        return sum(p.numel() for p in net.parameters()), float(counter.get_total_flops())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('specs', nargs='+', help='"ArchName:{yaml kwargs}"')
    p.add_argument('--lr-size', type=int, default=64)
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--plot', default=None, help='write scatter PNG here')
    args = p.parse_args(argv)

    import yaml
    rows = []
    for spec in args.specs:
        name, _, kw = spec.partition(':')
        opt = dict(yaml.safe_load(kw) or {}) if kw else {}
        opt['type'] = name
        n_params, flops = complexity(opt, args.lr_size, args.scale)
        out_pix = (args.lr_size * args.scale) ** 2
        rows.append({'arch': name, 'params_k': round(n_params / 1e3, 1),
                     'gflops': round(flops / 1e9, 2),
                     'kflops_per_out_pix': round(flops / out_pix / 1e3, 2)})
        print(json.dumps(rows[-1]))

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 6))
        for r in rows:
            ax.scatter(r['params_k'], r['gflops'], s=40 + 4 * r['kflops_per_out_pix'], alpha=0.7)
            ax.annotate(r['arch'], (r['params_k'], r['gflops']),
                        textcoords='offset points', xytext=(6, 4))
        ax.set_xlabel('Parameters (K)')
        ax.set_ylabel(f'GFLOPs @ {args.lr_size}x{args.lr_size} LR')
        ax.set_xscale('log')
        ax.set_yscale('log')
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f'plot -> {args.plot}')
    return rows


if __name__ == '__main__':
    main()
