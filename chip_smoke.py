"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, in phases; any failure ends the run with a
nonzero exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. builds the Swin block kernel from ``basicsr4rs_torch/csrc/`` with nvcc;
3. holds the kernel against its plain PyTorch version on the card at
   SwinIR-M block shapes (C=180, 6 heads, window 8, hidden 360), without
   and with the shift mask, in float32 and bfloat16, and at the shapes of
   the served requests, and times both;
4. serves SwinIR-M x4 through ``basicsr4rs_torch.test`` (the code path of
   ``python -m basicsr4rs_torch.test -opt options/test/SwinIR/
   test_SwinIR_M_x4_synthetic.yml``) on 4 synthetic image pairs and random
   seed-0 weights that it writes first, counts the kernel's launches, checks
   the outputs and times each request;
5. runs one request again with every block on the plain version and
   compares the two outputs.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = 'options/test/SwinIR/test_SwinIR_M_x4_synthetic.yml'
DATA_DIR = 'datasets/SwinIR_M_x4_synthetic'
WEIGHTS = 'experiments/SwinIR_M_x4_synthetic/net_g_seed0.pth'
LQ_SIZES = [(128, 128), (96, 160), (125, 94), (64, 64)]   # (H, W); 125x94 is padded
SCALE = 4
# kernel vs plain. float32: sums taken in another order, elementwise
# |err| <= atol + rtol |plain|. bfloat16: the plain version rounds every GEMM
# output and the residual stream y to bfloat16 where the kernel keeps
# float32, so errors are bf16 ulps of the largest magnitudes, not of each
# element: max|err| <= 1.6e-2 max|plain| (two ulps at the top of the range).
F32_TOL = (1e-4, 1e-4)   # (atol, rtol)
BF16_TOL = 1.6e-2
MODEL_TOLERANCE = 1e-3   # on the [0, 1] output: a quarter of one uint8 level


def fail(msg):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def phase(title):
    print(f'\n== {title}', flush=True)


def cuda_time_ms(fn, iters=20):
    """Mean milliseconds per call, CUDA events around ``iters`` calls after
    a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_info():
    phase('1. card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi: {smi.stderr.strip()}')
    print(smi.stdout.strip().splitlines()[0])
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')


def build_kernel():
    from basicsr4rs_torch.ops import _build
    phase('2. build')
    src = _build.CSRC_DIR / 'swin_block_joint_fwd.cu'
    t0 = time.perf_counter()
    lib = _build.build('swin_block_joint_fwd')
    print(f'built {os.path.relpath(src, ROOT)} -> {os.path.relpath(lib, ROOT)} in '
          f'{time.perf_counter() - t0:.2f} s with nvcc {" ".join(_build.NVCC_FLAGS)}')
    log = lib.with_name(lib.name + '.log').read_text()
    print('\n'.join(line.strip() for line in log.splitlines()
                    if 'registers' in line or 'spill' in line))
    if 'sm_90a' not in log:
        fail('the kernel was not compiled for sm_90a')


def block_inputs(b, h, w, dtype, shift, gen):
    """SwinIR-M block inputs on the card: x already rolled, weights with
    std 1/sqrt(fan_in) so that the attention is far from uniform."""
    from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
    c, heads, ws, hidden = 180, 6, 8, 360
    n = ws * ws

    def r(*shape, std=1.):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = r(b, h, w, c).to(dtype)
    args = [x, 1 + r(c, std=.1), r(c, std=.1), r(3 * c, c, std=c**-.5), r(3 * c, std=.02),
            r(c, c, std=c**-.5), r(c, std=.02), r(heads, n, n, std=.5),
            _shift_attn_mask(h, w, ws, shift, x.device) if shift else None,
            1 + r(c, std=.1), r(c, std=.1), r(hidden, c, std=c**-.5), r(hidden, std=.02),
            r(c, hidden, std=hidden**-.5), r(c, std=.02)]
    return args + [ws, heads, (c // heads)**-.5]


def check_block_kernel():
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full, reference_swin_block_full
    phase('3. kernel vs plain version (SwinIR-M block: C=180, 6 heads, window 8, hidden 360)')
    gen = torch.Generator().manual_seed(0)
    cases = [(2, 64, 64, dt, shift) for dt in (torch.float32, torch.bfloat16) for shift in (0, 4)]
    # the padded shapes of the served requests, one image each
    cases += [(1, h + (-h) % 8, w + (-w) % 8, torch.float32, 4) for h, w in LQ_SIZES]
    summary = {'max_abs_err': 0.}
    for b, h, w, dt, shift in cases:
        args = block_inputs(b, h, w, dt, shift, gen)
        with torch.no_grad():
            got = fused_swin_block_full(*args).float()
            want = reference_swin_block_full(*args).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f'non-finite kernel output at {(b, h, w, dt, shift)}')
        err = (got - want).abs()
        max_abs, max_rel = err.max().item(), err.max().item() / want.abs().max().item()
        if dt == torch.float32:
            ok = bool((err <= F32_TOL[0] + F32_TOL[1] * want.abs()).all())
            tolerance = f'|err| <= {F32_TOL[0]} + {F32_TOL[1]} |plain|'
        else:
            ok = max_rel <= BF16_TOL
            tolerance = f'max|err| <= {BF16_TOL} max|plain|'
        line = (f'B={b} {h}x{w} {str(dt)[6:]:8s} shift={shift}: max_abs_err={max_abs:.3e} '
                f'max_rel_err={max_rel:.3e} (max|err| / max|plain|), tolerance {tolerance}')
        with torch.no_grad():
            times = [cuda_time_ms(lambda: fn(*args)) for fn in
                     (reference_swin_block_full, fused_swin_block_full,
                      fused_swin_block_full, reference_swin_block_full)]
        kernel_ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        line += f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms'
        if (b, h, w, dt) == (1, 128, 128, torch.float32):   # the largest served request
            summary.update(ms=kernel_ms, plain_ms=plain_ms)
        print(line, flush=True)
        if not ok:
            fail(f'kernel and plain version disagree at {(b, h, w, dt, shift)}')
        if dt == torch.float32:
            summary['max_abs_err'] = max(summary['max_abs_err'], max_abs)
    return summary


def write_inputs():
    """4 synthetic GT/LQ pairs (smooth random images, LQ the bicubic
    downscale) and the seed-0 random SwinIR-M weights the config names."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(0)
    for sub in ('GT', 'LQ'):
        os.makedirs(os.path.join(DATA_DIR, sub), exist_ok=True)
    for i, (h, w) in enumerate(LQ_SIZES):
        coarse = rng.rand(h // 4 + 2, w // 4 + 2, 3).astype(np.float32)
        gt = cv2.resize(coarse, (SCALE * w, SCALE * h), interpolation=cv2.INTER_CUBIC)
        gt = (np.clip(gt, 0, 1) * 255).round().astype(np.uint8)
        lq = cv2.resize(gt, (w, h), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(DATA_DIR, 'GT', f'{i:04d}.png'), gt)
        cv2.imwrite(os.path.join(DATA_DIR, 'LQ', f'{i:04d}.png'), lq)
    net_opt = dict(yaml_load(CONFIG)['network_g'])
    net_opt.pop('type')
    net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0))
    os.makedirs(os.path.dirname(WEIGHTS), exist_ok=True)
    torch.save({'params': net.state_dict()}, WEIGHTS)
    return sum(net_opt['depths'])


def serve():
    import cv2
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    phase('4. serve SwinIR-M x4 through basicsr4rs_torch.test on cuda:0')
    blocks = write_inputs()
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', CONFIG]
    fused_swin_block_full.launches = 0
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_swin_block_full.launches
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, 4 requests, metrics, '
          f'image writes); kernel launches {launches} = {launches / len(LQ_SIZES):g} per request')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != blocks * len(LQ_SIZES):
        fail(f'expected {blocks} kernel launches per forward, counted {launches} '
             f'over {len(LQ_SIZES)} requests')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{name} is not finite')
    out_dir = os.path.join(model.opt['path']['visualization'], 'SwinIR_M_x4_synthetic')
    for i, (h, w) in enumerate(LQ_SIZES):
        img = cv2.imread(os.path.join(out_dir, f'{i:04d}_{model.opt["name"]}.png'))
        if img is None or img.shape != (SCALE * h, SCALE * w, 3):
            fail(f'saved image {i}: {None if img is None else img.shape}')

    # per-request latency of the model's own test(), after a warm-up request
    loader = [item for item in model_loader(model)]
    model.feed_data(loader[0])
    model.test()
    latencies = []
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.test()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        out = model.output
        if out.shape != (1, 3, SCALE * h, SCALE * w) or not torch.isfinite(out).all():
            fail(f'request {h}x{w}: output {tuple(out.shape)}')
        latencies.append(ms)
        print(f'request LQ {h}x{w} -> {SCALE * h}x{SCALE * w}: {ms:.3f} ms, '
              f'{SCALE * h * SCALE * w / ms / 1e3:.3f} output MP/s')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    return model, loader, launches


def model_loader(model):
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    dataset_opt = model.opt['datasets']['test_1']
    return build_dataloader(build_dataset(dataset_opt), dataset_opt)


def check_whole_model(model, loader):
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops.swin_block import reference_swin_block_full
    phase('5. whole model: kernel vs plain version, one request (LQ 125x94)')
    model.feed_data(loader[2])
    model.test()
    with_kernel = model.output.float().clamp(0, 1)
    with mock.patch.object(swinir_arch, 'fused_swin_block_full', reference_swin_block_full):
        model.test()
    plain = model.output.float().clamp(0, 1)
    err = (with_kernel - plain).abs().max().item()
    print(f'max abs error on the [0, 1] output: {err:.3e} (tolerance {MODEL_TOLERANCE})')
    if err > MODEL_TOLERANCE:
        fail('whole-model outputs disagree')


def main():
    if not torch.cuda.is_available():
        fail('no CUDA device')
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_info()
    build_kernel()
    kernel = check_block_kernel()
    model, loader, launches = serve()
    check_whole_model(model, loader)
    print(json.dumps({'kernels': [{
        'name': 'swin_block_joint_fwd', 'route': 'cuda',
        'source': 'basicsr4rs_torch/csrc/swin_block_joint_fwd.cu',
        'replaces': 'basicsr4rs_tpu/ops/swin_block.py:287', 'launches': launches,
        'max_abs_err': kernel['max_abs_err'], 'ms': kernel['ms'],
        'plain_ms': kernel['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
