"""Where a window's time goes in the joint Swin block kernels (K1, K11), a
(window, head) unit's in the attention branch's forward (K2, its first
launch) and backward (K3), a (token tile, part of the hidden chunks) unit's
in the MLP branch's forward (K4), a (token tile, hidden chunk) unit's in its
backward (K5), or a block's in the window-attention forward (K6) and
backward (K7).

    python -m basicsr4rs_torch.ops.joint_block_clock [--dtype float32|bfloat16]
    python -m basicsr4rs_torch.ops.joint_block_clock \
        --kernel attn_fwd|attn_bwd|mlp_fwd|mlp_bwd|wattn_fwd|wattn_bwd [--csrc DIR]

On one CUDA card. Builds a copy of ``csrc/`` under ``build/`` in which every
barrier of ``swin_block_joint.cuh`` (K1, K11), or of the kernel's block
kernel (the first of its ``.cu``) and the ``swin_common.cuh`` and
``branch_bwd.cuh`` helpers it calls (K2 to K7), reads
``clock64()`` on the first lane of each warp of block 0. K1 and K11 run on
a SwinIR-M block (C=180, 6 heads, window 8, hidden 360; B=1 128x128,
shifted), K2 to K5 on their training call (B=4 48x48, shifted,
DropPath's scales), weights of std 1/sqrt(fan_in) from a seed; K6 and K7 on
the ResShift UNet's largest call (B=16 64x64, C=192 in 6 heads of 32, window
8, shifted), from a seed. It prints, for each barrier, the work each warp
did since the one before: the slowest warp's, the mean and the fastest over
the warps that ran, averaged over 10 launches. The kernel is
barrier-synchronised, so the slowest warps' work summed over the barriers
is the block's time. ``--csrc`` instruments another checkout's kernel
sources (an earlier K2 to K7, whose C interface may differ), as they
stand. The kernels in ``csrc/`` are untouched.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from . import _build, _launch
from . import swin_block as S

SLOTS = 64          # barriers counted, the last slot is the kernel's end
# g_on: the clocked kernel is running (a helper's barrier may run in another
# kernel of the same library too: K2's proj launch)
DEFINE = '''namespace swin {
__device__ unsigned long long g_work[16][%d];
__device__ unsigned long long g_mark[16];
__device__ int g_on[16];
#define FIRST_LANE (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0)
#define CLOCKED (FIRST_LANE && ::swin::g_on[threadIdx.x >> 5])
#define START if (FIRST_LANE) { ::swin::g_on[threadIdx.x >> 5] = 1; \\
    ::swin::g_mark[threadIdx.x >> 5] = clock64(); }
#define STOP if (CLOCKED) { ::swin::g_on[threadIdx.x >> 5] = 0; \\
    ::swin::g_work[threadIdx.x >> 5][%d] += clock64() - ::swin::g_mark[threadIdx.x >> 5]; }
#define SYNC(s) { if (CLOCKED) \\
    ::swin::g_work[threadIdx.x >> 5][s] += clock64() - ::swin::g_mark[threadIdx.x >> 5]; \\
  __syncthreads(); \\
  if (CLOCKED) ::swin::g_mark[threadIdx.x >> 5] = clock64(); }
''' % (SLOTS, SLOTS - 1)
READ = '''
extern "C" void clock_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, swin::g_work, sizeof(swin::g_work));
}
extern "C" void clock_zero() {
  static unsigned long long z[16 * %d];
  cudaMemcpyToSymbol(swin::g_work, z, sizeof(z));
}
''' % SLOTS


def kernel_body(text, signature):
    """(start, end): the offsets just inside the braces of the function
    whose text begins with ``signature``."""
    start = text.index('{', text.index(signature)) + 1
    depth, at = 1, start
    while depth:
        at = re.search(r'[{}]', text[at:]).start() + at + 1
        depth += 1 if text[at - 1] == '{' else -1
    return start, at - 1


UNITS = {'attn_fwd': 'swin_attn_block_fwd', 'attn_bwd': 'swin_attn_block_bwd',   # K2, K3
         'mlp_fwd': 'mlp_block_fwd', 'mlp_bwd': 'mlp_block_bwd',                  # K4, K5
         'wattn_fwd': 'window_attention_fwd', 'wattn_bwd': 'window_attention_bwd'}   # K6, K7
KERNEL = '__global__ void __launch_bounds__('   # the block kernel: the first of the .cu
LN_LAUNCH = '// ------------------------------------------------------- the LayerNorm backward'


def instrumented_unit(src_dir, out_dir, name):
    """Copies src_dir to out_dir with the barriers of the block kernel of
    ``<name>.cu`` and of the helpers it calls counted: those of
    ``swin_common.cuh`` and of ``branch_bwd.cuh`` up to its LayerNorm
    launch, which runs as a kernel of its own. Returns (file, line) of each
    counted barrier."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    lines = []

    def counted(file, text, lo, hi):
        def count(match):
            lines.append((file, text[:lo + match.start()].count('\n') + 1))
            return f'SYNC({len(lines) - 1});'
        return text[:lo] + re.sub(r'__syncthreads\(\);', count, text[lo:hi]) + text[hi:]

    common = out_dir / 'swin_common.cuh'
    head, body = common.read_text().split('namespace swin {\n', 1)
    text = head + DEFINE + body   # DEFINE opens the namespace
    text = counted('swin_common.cuh', text, len(head) + len(DEFINE), len(text))
    common.write_text(text)
    shared = out_dir / 'branch_bwd.cuh'
    if shared.exists():   # an earlier checkout may have none
        text = shared.read_text()
        shared.write_text(counted('branch_bwd.cuh', text, 0, text.index(LN_LAUNCH)))
    path = out_dir / f'{name}.cu'
    text = path.read_text()
    _, hi = kernel_body(text, KERNEL)
    text = counted(f'{name}.cu', text, 0, hi)
    lo, hi = kernel_body(text, KERNEL)
    text = text[:lo] + '\n  START\n' + text[lo:hi] + '  STOP\n' + text[hi:]
    path.write_text(text + READ)
    assert len(lines) < SLOTS
    # the line numbers of the sources as they are, before the definitions went in
    shift = DEFINE.count('\n') - 1
    return [(file, line - shift if file == 'swin_common.cuh' else line) for file, line in lines]


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
    body = body.replace(start, start + '  START\n', 1)
    end = '      store2(out + offset(m) + o, v0, v1);\n    }\n'
    assert body.count(end) == 1
    body = body.replace(end, end + '  STOP\n')
    path.write_text(head + DEFINE + body + READ)
    return lines


def block_inputs(dtype, gen, b=1, h=128):
    """A shifted SwinIR-M block at B=b hxh on the card, as phase 3 of
    chip_smoke.py draws it."""
    from ..archs.swinir_arch import _shift_attn_mask
    c, heads, ws, hidden = 180, 6, 8, 360
    n = ws * ws

    def r(*shape, std=1.):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = r(b, h, h, c).to(dtype)
    return [x, 1 + r(c, std=.1), r(c, std=.1), r(3 * c, c, std=c**-.5), r(3 * c, std=.02),
            r(c, c, std=c**-.5), r(c, std=.02), r(heads, n, n, std=.5),
            _shift_attn_mask(h, h, ws, ws // 2, x.device),
            1 + r(c, std=.1), r(c, std=.1), r(hidden, c, std=c**-.5), r(hidden, std=.02),
            r(c, hidden, std=hidden**-.5), r(c, std=.02), ws, heads, (c // heads)**-.5]


def print_work(buf, total_of, where):
    """The slots of one kernel's clock, as main() describes them, over the
    warps that ran (the block kernels have 4 to 16)."""
    warps = [w for w in range(16) if any(buf[w * SLOTS + s] for s in range(SLOTS))]
    work = [[buf[w * SLOTS + s] / 10 for w in warps] for s in range(SLOTS)]
    total = sum(max(ws) for ws in work)
    print(f'{total_of}: {total:.0f} cycles, summed over the barriers\' slowest warps '
          f'({len(warps)} warps)')
    for s, ws in enumerate(work):
        if max(ws) < 0.01 * total:
            continue
        print(f'  {max(ws):9.0f} slowest {sum(ws) / len(ws):9.0f} mean {min(ws):9.0f} fastest '
              f'{100 * max(ws) / total:5.1f}%  before {where(s)}')


def instrumented_library(kernel, src_dir):
    """(library, counted barriers) of the unit kernel ``kernel``,
    instrumented from ``src_dir`` and built under ``build/``."""
    name = UNITS[kernel]
    out_dir = _build.BUILD_DIR.parent / f'{kernel}_clock'
    lines = instrumented_unit(src_dir, out_dir, name)
    flags = [str(out_dir) if f == str(_build.CSRC_DIR) else f for f in _build.NVCC_FLAGS]
    lib_path = out_dir / f'{name}.so'
    proc = subprocess.run([_build._nvcc(), *flags, '-o', str(lib_path),
                           str(out_dir / f'{name}.cu')],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f'nvcc failed on {name}:\n{proc.stdout}')
    return ctypes.CDLL(str(lib_path)), lines


def run_clocked(lib, run, lines, src_dir, total_of):
    """Runs ``run`` once, then 10 times with the clock zeroed, and prints
    the clock."""
    run()
    torch.cuda.synchronize()
    lib.clock_zero()
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (16 * SLOTS))()
    lib.clock_read(buf)
    texts = {file: (src_dir / file).read_text().split('\n') for file, _ in lines}

    def where(slot):
        if slot == SLOTS - 1:
            return 'the block\'s end'
        file, line = lines[slot]
        before = ' | '.join(t.strip() for t in texts[file][line - 3:line - 1] if t.strip())
        return f'{file}:{line}: {before[:80]}'

    print_work(buf, total_of, where)


def clock_window(kernel, dtype, src_dir):
    """K6 or K7 at the ResShift UNet's largest training call (B=16 64x64,
    C=192, 6 heads, window 8, shifted), instrumented from ``src_dir``; their C
    interfaces are the same in every version."""
    from ..archs.unet_arch import shift_attn_mask_resshift
    lib, lines = instrumented_library(kernel, src_dir)
    name = UNITS[kernel]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = getattr(lib, name)
    pointers = 3 if kernel == 'wattn_fwd' else 5
    launch.argtypes, launch.restype = [i] + [p] * pointers + [i] * 7 + [f, p], ctypes.c_int
    b, hw, c, heads, ws = 16, 64, 192, 6, 8
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, hw, hw, 3 * c, generator=gen).cuda().to(dtype)
    dout = torch.randn(b, hw, hw, c, generator=gen).cuda().to(dtype)
    mask = torch.from_numpy(shift_attn_mask_resshift(hw, hw, ws, ws // 2)).cuda()
    bias = (torch.randn(1, heads, ws * ws, ws * ws, generator=gen) * .5).cuda() + mask[:, None]
    dqkv, dbias = torch.empty_like(qkv), torch.empty_like(bias)
    dt = 0 if dtype == torch.float32 else 1
    tensors = ([qkv, bias, dout] if kernel == 'wattn_fwd' else [qkv, bias, dout, dqkv, dbias])

    def run():
        rc = launch(dt, *[t.data_ptr() for t in tensors], b, hw, hw, c, heads, ws, bias.shape[0],
                    (c // heads)**-.5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f'{name}: CUDA error {rc}')

    print(torch.cuda.get_device_name(0), str(dtype)[6:], f'B={b} {hw}x{hw} C={c} {heads} heads, '
          f'window {ws}, shifted; {src_dir}')
    run_clocked(lib, run, lines, src_dir, f'{name} block 0')


def clock_branch(kernel, dtype, src_dir):
    """K2, K3, K4 or K5 at its training call, instrumented from ``src_dir``,
    called through its C interface as that source declares it (an earlier
    one had no scratch buffer, no dtype in its shared-memory query, and K4
    no plan)."""
    name = UNITS[kernel]
    lib, lines = instrumented_library(kernel, src_dir)
    source = (src_dir / f'{name}.cu').read_text()
    b, hw = 4, 48
    (x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, rel, mask, ln2_w, ln2_b, w1, b1, w2, b2, ws,
     heads, scale) = block_inputs(dtype, torch.Generator().manual_seed(0), b=b, h=hw)
    c, hidden = x.shape[-1], w1.shape[0]
    dz = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).cuda().to(dtype)
    s = torch.full((b,), 1 / 0.9, device='cuda')
    s[1] = 0.
    dt = 0 if dtype == torch.float32 else 1
    scratch = [torch.empty_like(x) if kernel == 'attn_fwd' else
               torch.empty(x.numel(), device='cuda')] if 'scratch' in source else []
    plan = ''
    if kernel == 'mlp_fwd':
        args = [dt, x, torch.empty_like(x), b * hw * hw, c, hidden, hw * hw, ln2_w, ln2_b,
                w1.to(dtype), b1, w2.to(dtype), b2, 2, s]
        if f'{name}_plan' in source:   # the parts of the plan, their sums and counters
            query = getattr(lib, f'{name}_plan')
            query.argtypes, query.restype = [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
            grid = (ctypes.c_int * 5)()
            if query(dt, b * hw * hw, c, hidden, ctypes.addressof(grid)):
                raise SystemExit(f'{name}: its plan query failed')
            parts = grid[1]
            args += [parts, torch.empty(grid[4], device='cuda') if grid[4] else None]
            plan = f'; {grid[0]} units of {parts} part(s), {grid[2]} block(s) an SM'
    elif kernel == 'attn_fwd':
        args = [dt, x, torch.empty_like(x), b, hw, hw, c, heads, ws, ln1_w, ln1_b,
                wqkv.to(dtype), bqkv, wproj.to(dtype), bproj, rel, mask, 2, s, scale] + scratch
    else:
        floats = getattr(lib, f'{name}_grad_floats')
        floats.restype = ctypes.c_size_t
        if kernel == 'attn_bwd':
            floats.argtypes = [ctypes.c_int] * 3
            grads = torch.empty(floats(c, heads, ws), device='cuda')
            args = [dt, x, dz, torch.empty_like(x), b, hw, hw, c, heads, ws, ln1_w, ln1_b,
                    wqkv.to(dtype), bqkv, wproj.to(dtype), rel, mask, 2, s, scale, grads]
        else:
            floats.argtypes = [ctypes.c_int] * 2
            grads = torch.empty(floats(c, hidden), device='cuda')
            args = [dt, x, dz, torch.empty_like(x), b * hw * hw, c, hidden, hw * hw, ln2_w, ln2_b,
                    w1.to(dtype), b1, w2.to(dtype), 2, s, grads]
        args += scratch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = getattr(lib, name)
    launch.argtypes = [p if v is None or isinstance(v, torch.Tensor) else
                       f if isinstance(v, float) else i for v in args] + [p]
    values = [v.data_ptr() if isinstance(v, torch.Tensor) else v for v in args]
    # the shared-memory query by its parameters' names (of the unit launch)
    params = re.search(rf'size_t {name}_smem_bytes\(([^)]*)\)', source).group(1)
    known = {'dtype': dt, 'channels': c, 'heads': heads, 'hidden': hidden, 'launch': 0}
    smem_of = getattr(lib, f'{name}_smem_bytes')
    smem_of.restype = ctypes.c_size_t
    smem = smem_of(*[known[q.split()[-1]] for q in params.split(',')])

    def run():
        rc = launch(*values, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f'{name}: CUDA error {rc}')

    what = 'scaled' if kernel.startswith('mlp') else 'shifted, scaled'
    print(torch.cuda.get_device_name(0), str(dtype)[6:], f'B={b} {hw}x{hw} {what}, '
          f'SwinIR-M; {src_dir}; {smem} bytes of shared memory a block{plan}')
    run_clocked(lib, run, lines, src_dir, f'{name} block 0')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--dtype', choices=('float32', 'bfloat16'), default='float32')
    parser.add_argument('--kernel', choices=('joint', *UNITS), default='joint')
    parser.add_argument('--csrc', type=Path, default=_build.CSRC_DIR,
                        help='kernel sources to instrument (all but joint)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('joint_block_clock: needs a CUDA card')
    if args.kernel in ('wattn_fwd', 'wattn_bwd'):
        clock_window(args.kernel, getattr(torch, args.dtype), args.csrc.resolve())
        return
    if args.kernel in UNITS:
        clock_branch(args.kernel, getattr(torch, args.dtype), args.csrc.resolve())
        return
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
        print_work(buf, f'{name} a window', lambda s: 'the kernel\'s end' if s == SLOTS - 1 else (
            f'line {lines[s]}: ' + ' | '.join(
                t.strip() for t in source[lines[s] - 3:lines[s] - 1] if t.strip())[:90]))
    S._lib.cache_clear()


if __name__ == '__main__':
    main()
