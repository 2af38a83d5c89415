"""K9's time at the video paths' shapes, and what each part of it costs.

    python -m basicsr4rs_torch.ops.deform_sample_sweep [--variants]
    cd <another checkout> && python <this file>

On one CUDA card. By default, for each case (EDVR-M's and BasicVSR++'s
deformable convolutions at their training and serving shapes, nine taps;
the one-tap warps of BasicVSR++ and SpyNet) it prints the time of
``dcn.deform_sample_backward`` by CUDA events over 20 calls, its device time
by ``torch.profiler`` (every kernel and memory operation of a call) and the
device operations a call; then the same for ``flow_warp``'s backward through
autograd, the flow handed over as BasicVSR++ does (a permuted (N, 2, H, W)
map). Inputs come from a seed: offsets drawn per pixel with the spread
given, or a smooth field (one offset a tap and group, plus a tenth of a
pixel drawn per pixel). It uses only what every checkout's wrappers offer
since K9's port, so run as a file from another checkout's root it times that
checkout's K9.

``--variants`` builds copies of ``csrc/deform_sample_bwd.cu`` with one change
each into ``build/`` (the blocks an SM that the registers allow; the shared
adds left out or made plain, racing adds; the window's flush or its centre
left out) and times each on the cases where the kernel's parts differ, the
gradients of the offsets alone and of the map alone as well: what each part
costs. The results of the changed copies are wrong by design and not
checked; the kernel in ``csrc/`` is untouched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

F32, BF16 = torch.float32, torch.bfloat16
# (tag, N, C, H, W, taps, deform groups, mask, dtype, offsets: spread in px or 'smooth')
CASES = [('EDVR train L1', 20, 64, 64, 64, 9, 8, True, F32, 2.),
         ('EDVR train L1 smooth', 20, 64, 64, 64, 9, 8, True, F32, 'smooth'),
         ('EDVR train L1 bf16', 20, 64, 64, 64, 9, 8, True, BF16, 2.),
         ('EDVR serve L1', 5, 64, 180, 320, 9, 8, True, F32, 2.),
         ('BasicVSR++ train', 1, 128, 64, 64, 9, 16, True, F32, 4.),
         ('BasicVSR++ serve', 1, 128, 180, 320, 9, 16, True, F32, 4.),
         ('warp 64ch', 1, 64, 64, 64, 1, 1, False, F32, 3.),
         ('warp 64ch serve', 1, 64, 180, 320, 1, 1, False, F32, 3.),
         ('warp 2ch flow', 1, 2, 64, 64, 1, 1, False, F32, 3.),
         ('warp 3ch SpyNet', 58, 3, 64, 64, 1, 1, False, F32, 3.)]
VARIANT_CASES = ('EDVR train L1', 'EDVR train L1 smooth', 'BasicVSR++ train', 'warp 64ch')
SHARED_ADD = '  if (in_window)\n    atomicAdd(w, v);'
# one change each to csrc/deform_sample_bwd.cu
VARIANTS = {
    'as built': [],
    '3 blocks an SM': [('kMinBlocks = 4;', 'kMinBlocks = 3;')],
    '5 blocks an SM': [('kMinBlocks = 4;', 'kMinBlocks = 5;')],
    'no shared adds': [(SHARED_ADD, '  if (in_window) {\n  }')],
    'plain shared adds': [(SHARED_ADD, '  if (in_window)\n    *w += v;')],
    'no flush': [('if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;',
                  'continue;')],
    'no centre': [('      if (valid && slice == 0) {\n        for (int k = k_begin',
                   '      if (false) {\n        for (int k = k_begin')],
}


def inputs(case, gen):
    """x, offset, mask, dcol and the geometry of a case, on the card."""
    from basicsr4rs_torch.ops.dcn import SampleGeometry
    _, n, c, h, w, taps, groups, with_mask, dtype, spread = case
    k = 3 if taps == 9 else 1
    geo = SampleGeometry(k, k, 1, k // 2, 1, groups)
    x = torch.randn(n, c, h, w, generator=gen).to(dtype)
    if spread == 'smooth':
        base = torch.rand(1, groups * 2 * taps, 1, 1, generator=gen) * 4 - 2
        offset = base + .1 * torch.randn(n, groups * 2 * taps, h, w, generator=gen)
    else:
        offset = torch.randn(n, groups * 2 * taps, h, w, generator=gen) * spread
    mask = torch.rand(n, groups * taps, h, w, generator=gen).cuda() if with_mask else None
    dcol = torch.randn(n, c, taps, h, w, generator=gen).to(dtype)
    return x.cuda(), offset.cuda(), mask, dcol.cuda(), geo


def events_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """(ms, device operations) a call: every kernel and memory operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and '#' not in e.key]
    return sum(t for t, _ in rows) / 1e3 / iters, sum(n for _, n in rows) / iters


def time_cases(cases, needs=((True, True),)):
    """Events ms, device ms and operations a call of each case and need."""
    from basicsr4rs_torch.ops import dcn as D
    gen = torch.Generator().manual_seed(4)
    for case in cases:
        x, offset, mask, dcol, geo = inputs(case, gen)
        for need in needs:
            def call():
                return D.deform_sample_backward(x, offset, mask, dcol, geo, *need)
            with torch.no_grad():
                ms = events_ms(call)
                dev, ops = device_ms(call)
            what = {(True, True): '', (False, True): ', d offset and d mask only',
                    (True, False): ', dx only'}[need]
            print(f'K9 {case[0]:22s}{what:26s} events {ms:.4f} ms, device {dev:.4f} ms '
                  f'in {ops:g} operations a call', flush=True)


def time_flow_warps():
    from basicsr4rs_torch.archs.arch_util import flow_warp
    gen = torch.Generator().manual_seed(5)
    for c in (64, 2):
        x = torch.randn(1, c, 64, 64, generator=gen).cuda().requires_grad_()
        flow = (torch.randn(1, 2, 64, 64, generator=gen) * 3.).cuda().requires_grad_()
        dout = torch.randn(1, c, 64, 64, generator=gen).cuda()
        out = flow_warp(x, flow.permute(0, 2, 3, 1))

        def call():
            return torch.autograd.grad(out, (x, flow), dout, retain_graph=True)
        ms = events_ms(call)
        dev, ops = device_ms(call)
        print(f'flow_warp {c}ch 64x64 backward (autograd) events {ms:.4f} ms, device '
              f'{dev:.4f} ms in {ops:g} operations a call', flush=True)


def variants():
    from basicsr4rs_torch.ops import _build, _launch
    from basicsr4rs_torch.ops import dcn as D
    source = (_build.CSRC_DIR / 'deform_sample_bwd.cu').read_text()
    out = _build.BUILD_DIR.parent / 'deform_sample_sweep'
    out.mkdir(parents=True, exist_ok=True)
    running = []
    for i, (name, changes) in enumerate(VARIANTS.items()):
        text = source
        for old, new in changes:
            if old not in text:
                raise SystemExit(f'variant {name!r}: {old!r} is not in the source')
            text = text.replace(old, new)
        src, lib = out / f'variant{i}.cu', out / f'variant{i}.so'
        src.write_text(text)
        running.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cases = [case for case in CASES if case[0] in VARIANT_CASES]
    load = _launch.load_library
    try:
        for name, lib, proc in running:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f'variant {name!r} does not build:\n{log}')
            registers = sorted(set(line.split('Used ')[1].split(' registers')[0]
                                   for line in log.splitlines() if 'registers' in line))
            spills = sorted(set(line.split(', ')[1].split(' bytes')[0]
                                for line in log.splitlines() if 'spill stores' in line))
            print(f'== {name}: {"/".join(registers)} registers a thread, '
                  f'{"/".join(spills)} bytes of spill stores', flush=True)
            handle = ctypes.CDLL(str(lib))
            _launch.load_library = lambda _name, handle=handle: handle
            D._lib.cache_clear()
            time_cases(cases, needs=((True, True), (False, True), (True, False)))
    finally:
        _launch.load_library = load
        D._lib.cache_clear()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variants', action='store_true',
                        help='time copies of the kernel with one part changed each')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('deform_sample_sweep: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'{torch.cuda.get_device_name(0)}; K9 of {Path.cwd()}', flush=True)
    if args.variants:
        variants()
        return
    time_cases(CASES)
    time_flow_warps()


if __name__ == '__main__':
    if __package__ in (None, ''):   # run as a file: time the checkout it is run from
        sys.path.insert(0, os.getcwd())
    main()
