"""Where a window's time goes in the joint Swin block kernels (K1, K11).

    python -m basicsr4rs_torch.ops.joint_block_clock [--dtype float32|bfloat16]

On one CUDA card. Builds a copy of ``csrc/`` under ``build/joint_block_clock/``
in which every barrier of ``swin_block_joint.cuh`` reads ``clock64()`` on
the first lane of each warp of block 0, runs both kernels on a SwinIR-M
block (C=180, 6 heads, window 8, hidden 360; B=1 128x128, shifted, weights
of std 1/sqrt(fan_in) from a seed) and prints, for each barrier, the work
each warp did since the one before: the slowest warp's, the mean and the
fastest, averaged over 10 launches. The kernel is barrier-synchronised, so
the slowest warps' work summed over the barriers is the window's time.
The kernels in ``csrc/`` are untouched.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

import torch

from . import _build, _launch
from . import swin_block as S

SLOTS = 64          # barriers counted, the last slot is the kernel's end
DEFINE = '''namespace swin {
__device__ unsigned long long g_work[16][%d];
__device__ unsigned long long g_mark[16];
#define SYNC(s) { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) \\
    g_work[threadIdx.x >> 5][s] += clock64() - g_mark[threadIdx.x >> 5]; \\
  __syncthreads(); \\
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) g_mark[threadIdx.x >> 5] = clock64(); }
''' % SLOTS
READ = '''
extern "C" void clock_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, swin::g_work, sizeof(swin::g_work));
}
extern "C" void clock_zero() {
  static unsigned long long z[16 * %d];
  cudaMemcpyToSymbol(swin::g_work, z, sizeof(z));
}
''' % SLOTS


def instrumented_sources(out_dir):
    """Copies csrc/ to out_dir with the joint header's barriers counted;
    returns the source line of each counted barrier."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out_dir)
    path = out_dir / 'swin_block_joint.cuh'
    head, body = path.read_text().split('namespace swin {\n', 1)
    lines = []

    def count(match):
        lines.append(head.count('\n') + body[:match.start()].count('\n') + 2)
        return f'SYNC({len(lines) - 1});'

    body = re.sub(r'__syncthreads\(\);', count, body)
    assert len(lines) < SLOTS
    start = 'extern __shared__ __align__(16) uint32_t smem[];\n'
    body = body.replace(start, start + '  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) '
                        'g_mark[threadIdx.x >> 5] = clock64();\n', 1)
    end = '      store2(out + offset(m) + o, v0, v1);\n    }\n'
    assert body.count(end) == 1
    body = body.replace(end, end + '  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) '
                        f'g_work[threadIdx.x >> 5][{SLOTS - 1}] += clock64() - '
                        'g_mark[threadIdx.x >> 5];\n')
    path.write_text(head + DEFINE + body + READ)
    return lines


def block_inputs(dtype, gen):
    """A shifted SwinIR-M block at B=1 128x128 on the card, as phase 3 of
    chip_smoke.py draws it."""
    from ..archs.swinir_arch import _shift_attn_mask
    c, heads, ws, hidden, h = 180, 6, 8, 360, 128
    n = ws * ws

    def r(*shape, std=1.):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = r(1, h, h, c).to(dtype)
    return [x, 1 + r(c, std=.1), r(c, std=.1), r(3 * c, c, std=c**-.5), r(3 * c, std=.02),
            r(c, c, std=c**-.5), r(c, std=.02), r(heads, n, n, std=.5),
            _shift_attn_mask(h, h, ws, ws // 2, x.device),
            1 + r(c, std=.1), r(c, std=.1), r(hidden, c, std=c**-.5), r(hidden, std=.02),
            r(c, hidden, std=hidden**-.5), r(c, std=.02), ws, heads, (c // heads)**-.5]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--dtype', choices=('float32', 'bfloat16'), default='float32')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('joint_block_clock: needs a CUDA card')
    out_dir = _build.BUILD_DIR.parent / 'joint_block_clock'
    lines = instrumented_sources(out_dir)
    source = (_build.CSRC_DIR / 'swin_block_joint.cuh').read_text().split('\n')
    flags = [str(out_dir) if f == str(_build.CSRC_DIR) else f for f in _build.NVCC_FLAGS]
    runs = {'swin_block_joint_fwd': S.swin_block_full_forward,
            'swin_block_joint_int8_fwd': S.swin_block_full_int8}
    procs = {name: subprocess.Popen([_build._nvcc(), *flags, '-o', str(out_dir / f'{name}.so'),
                                     str(out_dir / f'{name}.cu')],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in runs}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f'nvcc failed on {name}:\n{log}')
    dtype = getattr(torch, args.dtype)
    inputs = block_inputs(dtype, torch.Generator().manual_seed(0))
    print(torch.cuda.get_device_name(0), args.dtype, 'B=1 128x128 shifted, SwinIR-M')
    for name, run in runs.items():
        lib = ctypes.CDLL(str(out_dir / f'{name}.so'))
        _launch.load_library = lambda _, lib=lib: lib   # the wrapper binds the copy
        S._lib.cache_clear()
        with torch.no_grad():
            run(*inputs)
            torch.cuda.synchronize()
            lib.clock_zero()
            for _ in range(10):
                run(*inputs)
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (16 * SLOTS))()
        lib.clock_read(buf)
        work = [[buf[w * SLOTS + s] / 10 for w in range(16)] for s in range(SLOTS)]
        total = sum(max(ws) for ws in work)
        print(f'{name}: {total:.0f} cycles a window, summed over the barriers\' slowest warps')
        for s, ws in enumerate(work):
            if max(ws) < 0.01 * total:
                continue
            where = 'the kernel\'s end' if s == SLOTS - 1 else (
                f'line {lines[s]}: ' + ' | '.join(
                    t.strip() for t in source[lines[s] - 3:lines[s] - 1] if t.strip())[:90])
            print(f'  {max(ws):9.0f} slowest {sum(ws) / 16:9.0f} mean {min(ws):9.0f} fastest '
                  f'{100 * max(ws) / total:5.1f}%  before {where}')
    S._lib.cache_clear()


if __name__ == '__main__':
    main()
