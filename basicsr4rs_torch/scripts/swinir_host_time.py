"""Host and device time of a SwinIR-M x4 request and training step on one
card.

    python -m basicsr4rs_torch.scripts.swinir_host_time [--repeats 20]
    cd <another checkout> && python <this file>

SwinIR-M x4 at its published widths (embed 180, depths 6 x 6, heads 6,
window 8, mlp_ratio 2) with seed-0 weights, float32, TF32 off:

- a request: LQ 128x128, batch 1, ``eval()`` under ``torch.inference_mode``
  (K1 a block);
- a training step: batch 4 of LQ 48x48 (GT 192), L1 loss, backward, Adam
  (K2 and K4 forward, K3 and K5 backward, a block).

For each, after warm-up, the median and the quartiles over ``--repeats`` of:
the host time of issuing it (the clock from the call to its return, the
queue drained before), its latency (to the end of a synchronize) and its
device span (CUDA events around it). Where the package defines its kernels
as ``basicsr4rs::`` operators (``ops/library.py``), also the host time a
call of K1, K2, K4 and K10 takes through its operator and through its
ctypes launch alone, 200 calls each at the request's and the step's shapes.
Prints one JSON line, with the card's name and power limit as
``nvidia-smi`` gives them. It uses only what every checkout's package has
offered since the split training route, so run as a file from another
checkout's root it times that checkout (whose kernels build into its own
``build/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = dict(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.,
              depths=[6] * 6, embed_dim=180, num_heads=[6] * 6, mlp_ratio=2.,
              upsampler='pixelshuffle', resi_connection='1conv')
REQUEST, STEP = (1, 128, 128), (4, 48, 48)


def timed(fn, repeats):
    """{host_ms, latency_ms, events_ms: [median, first quartile, third
    quartile]} of ``fn`` over ``repeats`` calls after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = {'host_ms': [], 'latency_ms': [], 'events_ms': []}
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs['host_ms'].append((t1 - t0) * 1e3)
        runs['latency_ms'].append((t2 - t0) * 1e3)
        runs['events_ms'].append(start.elapsed_time(end))
    return {k: [float(np.median(v)), float(np.percentile(v, 25)), float(np.percentile(v, 75))]
            for k, v in runs.items()}


def per_call_us(fn, calls=200):
    """Host microseconds a call of ``fn`` takes to issue, over ``calls``
    calls with the queue drained before (their device work stays queued)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def op_overhead(gen):
    """{kernel: [us a call through its op, us through its launch alone]} at
    SwinIR-M's widths: K1 on the request's 128x128 map, K2 and K4 on the
    step's 4 x 48x48, K10 180 -> 180 on 128x128 with the residual."""
    from basicsr4rs_torch.ops import conv3x3, mlp_block, swin_block

    def r(*shape, std=1.):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    c, heads, ws, hidden = 180, 6, 8, 360
    n, geometry = ws * ws, (ws, heads, (c // heads)**-.5)

    def block(b, h, w):
        return [r(b, h, w, c), 1 + r(c, std=.1), r(c, std=.1), r(3 * c, c, std=c**-.5),
                r(3 * c, std=.02), r(c, c, std=c**-.5), r(c, std=.02), r(heads, n, n, std=.5),
                None, 1 + r(c, std=.1), r(c, std=.1), r(hidden, c, std=c**-.5),
                r(hidden, std=.02), r(c, hidden, std=hidden**-.5), r(c, std=.02)]

    served, step = block(1, 128, 128), block(4, 48, 48)
    attn = step[:9] + [*geometry, True, None]
    mlp = [step[0], *step[9:15], True, None]
    x, weight = r(1, c, 128, 128), r(c, c, 3, 3, std=(9 * c)**-.5)
    conv = [x, weight, r(c, std=.02), r(1, c, 128, 128), None]
    cases = {
        'K1': (lambda: swin_block.swin_block_full_forward(*served, *geometry),
               lambda: swin_block._launch_joint(*served, *geometry)),
        'K2': (lambda: swin_block.swin_attn_block_forward(*attn),
               lambda: swin_block._launch_attn_forward(*attn)),
        'K4': (lambda: mlp_block.mlp_block_forward(*mlp),
               lambda: mlp_block._launch_forward(*mlp)),
        'K10': (lambda: conv3x3.conv3x3_forward(*conv),
                lambda: conv3x3._launch_forward(*conv)),
    }
    with torch.no_grad():
        return {k: [per_call_us(op), per_call_us(launch)] for k, (op, launch) in cases.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--repeats', type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('swinir_host_time: no CUDA device')
    import basicsr4rs_torch
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    gen = torch.Generator().manual_seed(0)
    net = SwinIR(**CONFIG, generator=gen).cuda()
    lq = torch.rand(*REQUEST[:1], 3, *REQUEST[1:], generator=gen).cuda()
    batch = torch.rand(*STEP[:1], 3, *STEP[1:], generator=gen).cuda()
    gt = torch.rand(STEP[0], 3, 4 * STEP[1], 4 * STEP[2], generator=gen).cuda()
    optimizer = torch.optim.Adam(net.parameters(), lr=2e-4)

    def request():
        with torch.inference_mode():
            net(lq)

    def step():
        optimizer.zero_grad(set_to_none=True)
        (net(batch) - gt).abs().mean().backward()
        optimizer.step()

    net.eval()
    served = timed(request, args.repeats)
    net.train()
    trained = timed(step, args.repeats)
    has_ops = importlib.util.find_spec('basicsr4rs_torch.ops.library') is not None
    print(json.dumps({'card': card[0] if card else None,
                      'package': os.path.dirname(os.path.abspath(basicsr4rs_torch.__file__)),
                      'torch': torch.__version__, 'repeats': args.repeats,
                      'request': served, 'step': trained,
                      'op_us_vs_launch_us': op_overhead(gen) if has_ops else None}))


if __name__ == '__main__':
    if not __package__:   # run as a file: time the package of the current checkout
        sys.path.insert(0, os.getcwd())
    main()
