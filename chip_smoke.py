"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, in phases; any failure ends the run with a
nonzero exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. builds the eleven kernels (five Swin block kernels and the W8A8 joint
   block, the window attention forward and backward, the deformable sampler
   forward and backward, the 3x3 convolution) from
   ``basicsr4rs_torch/csrc/`` with nvcc, all at once;
3. holds each kernel against its plain PyTorch version on the card at
   SwinIR-M block shapes (C=180, 6 heads, window 8, hidden 360), without
   and with the shift mask, in float32 and bfloat16, and times both: the
   joint forward kernel also at the shapes of the served requests, at
   SwinIR-light's widths (C=60, heads of 10) and with a window of 4; the
   attention and MLP branch kernels, forward and backward, at the training
   shape (batch 4 of 48x48) in their three output modes, every gradient by
   name, and where their tiles are padded: the attention kernels at
   SwinIR-light's widths, a window of 4 and heads of 48, the MLP kernels at
   SwinIR-light's widths and at 480 tokens (not a multiple of their
   64-token tile), and both forward kernels at the eval route's widths past
   the joint kernel's (C=180 in 3 heads of 60, C=240 in 8 heads of 30); the
   two forward kernels, which add nothing atomically, must repeat bit for
   bit, the attention forward's two launches' device time is read by
   ``torch.profiler``, and the MLP forward's grid is printed (units, parts
   of the hidden chunks, blocks an SM, how full the waves are);
   the window-attention kernels at the shapes of the
   ResShift UNet (C=192, 6 heads of 32, window 8; maps of 64, 32, 16 and 8;
   batch 1 and the training batch; with the shift mask and without), at
   window 9 on the latents of ``train_ResShift_L2S288.yml`` (maps of 72, 36
   and 18 shifted by 4, and 9 as one window; its batch 32 in bfloat16, 16 in
   float32) and at C=180 with heads of 30, beside
   ``F.scaled_dot_product_attention`` (and its backward by autograd) as a
   yardstick, with each kernel's grid and fill (units, samples a unit,
   blocks an SM, stages) and, for the forward at batch 1, its device time;
   the deformable sampler's kernels (3d) at the shapes EDVR-M gives them
   (64 channels in 8 groups, nine taps; training batch 4 x 5 frames of 64x64
   and a served window of 5 frames of 180x320, all three pyramid levels) and
   BasicVSR++ (128 channels in 16 groups; one tap on 64-, 3- and 2-channel
   maps for the flow warps, also with ``border``), with offsets small and
   large enough to leave the map and whole positions among them, beside
   ``F.grid_sample`` as the one-tap yardstick, and the warps as ``flow_warp``
   runs them (the flow read through its strides; call time and device time
   beside ``F.grid_sample``'s; gradients); the 3x3 convolution kernel
   (3e) at the shapes SwinIR-M x4 gives it (180->180 on the LQ map, 180->64,
   64->256 on the LQ and the 2x map, 64->64 on the 4x map, one odd size; and
   180->180 channels-last and as the RSTB's view of its tokens), all four
   epilogues in both types, beside ``F.conv2d`` + its epilogue, and its
   gradients; the
   W8A8 joint block (3f) against its plain version by the rule stated there,
   against the float block by SNR, and timed beside the float kernel, also
   past the float kernel's widths (C=180 in 3 heads of 60, C=240 in 8 heads
   of 30, B=2 64x64: its wide variant);
4. serves SwinIR-M x4 through ``basicsr4rs_torch.test`` (the code path of
   ``python -m basicsr4rs_torch.test -opt options/test/SwinIR/
   test_SwinIR_M_x4_synthetic.yml``) on 4 synthetic image pairs and random
   seed-0 weights that it writes first, counts the kernel's launches, checks
   the outputs and times each request; 4b breaks two requests of each size
   down by kernel group with ``torch.profiler``;
5. runs one request again with every block on the plain version and
   compares the two outputs;
6. trains SwinIR-M x4 through ``basicsr4rs_torch.train`` (the code path of
   ``python -m basicsr4rs_torch.train -opt options/train/SwinIR/
   train_SwinIR_M_x4_synthetic.yml``) for 8 steps of batch 4 at GT 192 on
   synthetic pairs that it writes first, with two validations and
   checkpoints inside: counts every kernel's launches per step, checks that
   the loss is finite and falls on a fixed batch, the EMA, the saved
   ``.pth`` and a resume from the saved ``.state``, times the steps, and
   breaks three more steps down by kernel with ``torch.profiler``;
7. runs one training batch forward and backward through the kernels and
   through their plain versions, with the same DropPath masks, and compares
   the loss and every parameter's gradient;
8. serves ResShift x4 through ``basicsr4rs_torch.test`` (``-opt
   options/test/ResShift/test_ResShift_x4_synthetic.yml``: UNetModelSwin at
   the published width behind a VQ-f4 first stage, 15 reverse steps) on 4
   synthetic pairs and seed-0 weights that it writes first: 270 launches of
   the attention kernel a request, latency after a warm-up request, one
   request again on the plain versions with the same seed, and where the
   device time of a request goes (``torch.profiler``);
9. trains it through ``basicsr4rs_torch.train`` (``-opt
   options/train/ResShift/train_ResShift_x4_synthetic.yml``) for 8 steps:
   18 launches of each attention kernel a step, finite losses, step time,
   peak memory, EMA, checkpoint, resume, the device time of a step by
   kernel, and two steps under bfloat16 autocast;
10. runs one ResShift training batch forward and backward through the
    kernels and through the plain versions and compares every gradient;
    10b. builds ``UNetModelSwin`` from ``network_g`` of
    ``options/train/ResShift/train_ResShift_L2S288.yml`` as it stands
    (window 9, 6 channels in and out, latents 72x72) with seed-0 weights and
    runs B=2 forward and backward through the kernels (18 launches of each
    attention kernel) and through the plain versions: the output and every
    gradient;
11. serves EDVR-M x4 through ``basicsr4rs_torch.test`` (``-opt
    options/test/EDVR/test_EDVR_M_x4_synthetic.yml``: ``VideoTestDataset``,
    windows of 5 LQ frames of 180x320, per-clip PSNR) on two synthetic clips
    and seed-0 weights that it writes first: 4 launches of the sampler a
    request, latency after a warm-up request, one request again on the plain
    versions, the device time of a request by kernel;
12. trains it through ``basicsr4rs_torch.train`` (``-opt
    options/train/EDVR/train_EDVR_M_x4_synthetic.yml``: ``REDSDataset``,
    batch 4, GT 256) for 8 steps: 4 forward and 4 backward launches a step,
    a finite loss that falls on the first batch, the end of the TSA-only
    warm-up at iteration 4 (a frozen parameter keeps its value before it and
    moves from it on), EMA, checkpoint, resume, step time, peak memory, the
    device time of a step by kernel;
13. runs one EDVR training batch forward and backward through the kernels
    and through the plain versions and compares every gradient;
14. to 16. the same three for BasicVSR++ (``options/test/BasicVSRPP/
    test_BasicVSRPP_x4_synthetic.yml``: one clip of 30 frames of 180x320 in
    one forward, 462 launches, and its device memory stage by stage;
    ``options/train/BasicVSRPP/
    train_BasicVSRPP_x4_synthetic.yml``: ``REDSRecurrentDataset``, batch 1 of
    30 frames, 462 forward and 461 backward launches a step, SpyNet frozen
    before iteration 4);
17. serves SwinIR-M x4 through ``basicsr4rs_torch.test`` again with
    ``SWIN_FUSED_CONV=1``: 10 launches of the convolution kernel a forward,
    outputs against the cuDNN route, latency of both routes;
18. runs it under ``quantized_inference(net, min_channels=10**9,
    swin_kernels=True)`` at B=16 of LQ 64x64 and at the 128x128 request: 36
    launches of the W8A8 block a forward, the kernel route against the plain
    route, SNR against the float output with the blocks' linears redrawn at
    full scale, output MP/s of both;
19. serves MSRResNet x4 through ``basicsr4rs_torch.test`` (``-opt
    options/test/SRResNet_SRGAN/test_MSRResNet_x4_synthetic.yml``) in float,
    ``val:quant_int8=true`` and ``=static``: SNR against float, latency of
    the three; then trains it for 8 steps through ``basicsr4rs_torch.train``
    (``-opt options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml``);
20. runs ``basicsr4rs_torch.inference.inference_swinir --tile 128`` on one LQ
    512x512 image (16 tiles in one batch) and holds it against the untiled
    forward, with the device memory of both (and of the tiled one with
    ``SWIN_FUSED_CONV=1``) stage by stage; MSRResNet tiled with a pad that
    covers its receptive field;
21. trains SwinIR-M x4 for 4 steps with ``SWIN_JOINT_TRAIN=1``: launch
    counts per step, gradients against the split route, step time;
22. serves SwinIR (depths [2, 2], LQ 64x64, eval) at widths past the joint
    kernel's: C=180 in 3 heads of 60 and SwinIR-L's C=240 in 8 heads of 30
    through the attention and MLP branch forward kernels, no joint launch,
    against its plain forward; then, with the blocks' linears at full scale,
    under ``swin_kernels=True``: the W8A8 block alone, against the float
    forward by phase 18's SNR bound; a width refused fails the phase.

``python3 chip_smoke.py kernels`` stops after phase 3; ``python3 chip_smoke.py
serving`` runs phases 3a, 3e, 3f, 4, 4b and 17 to 22 alone. The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
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
# float32 parameter gradients are sums over every token of the call (9216 at
# the training shape), added by atomicAdd in an order that changes from run
# to run; an entry's error follows the size of the sum's terms, not of the
# entry, so the bound is relative to the largest entry: max|err| <= 1e-4 max|plain|.
F32_SUM_TOL = 1e-4
BF16_TOL = 1.6e-2
MODEL_TOLERANCE = 1e-3   # on the [0, 1] output: a quarter of one uint8 level
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 on the CUDA
# cores, dense bfloat16 on the tensor cores, HBM3
PEAK_FLOPS_F32, PEAK_FLOPS_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_FLOPS_TF32 = 495e12   # dense TF32 on the tensor cores


def fail(msg):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def phase(title):
    print(f'\n== {title}', flush=True)


def cuda_time_ms(fn, iters=10):
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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')
    return card


def build_kernels():
    from basicsr4rs_torch.ops import _build
    phase('2. build')
    t0 = time.perf_counter()
    libs = _build.build_all()   # one nvcc per source, all at once
    print(f'built {len(libs)} kernels in {time.perf_counter() - t0:.2f} s with nvcc '
          f'{" ".join(_build.NVCC_FLAGS)}')
    for name, lib in libs.items():
        print(f'{os.path.relpath(_build.CSRC_DIR / (name + ".cu"), ROOT)} -> '
              f'{os.path.relpath(lib, ROOT)}')
        log = lib.with_name(lib.name + '.log').read_text()
        keep = ('registers', 'spill') + (('Compiling entry',) if name == 'conv3x3_fwd' else ())
        print('\n'.join('  ' + line.strip() for line in log.splitlines()
                        if any(k in line for k in keep)))
        if 'sm_90a' not in log:
            fail(f'{name} was not compiled for sm_90a')


C, HEADS, WS, HIDDEN = 180, 6, 8, 360   # a SwinIR-M block


def block_inputs(b, h, w, dtype, shift, gen, c=C, heads=HEADS, ws=WS, hidden=HIDDEN):
    """Block inputs on the card (SwinIR-M's widths unless given): x already
    rolled, weights with std 1/sqrt(fan_in) so that the attention is far
    from uniform."""
    from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
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


def bound_ms(flop, nbytes, dtype):
    """The least time the card could take: the larger of operations over the
    peak rate of the type (float32 on the CUDA cores, bfloat16 on the tensor
    cores) and bytes over the memory rate; and which of the two it is."""
    peak = PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS_BF16
    by_ops, by_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, 'operations') if by_ops >= by_bytes else (by_bytes, 'bytes')


M_WIDTHS = (C, HEADS, WS, HIDDEN)
LIGHT_WIDTHS = (60, 6, 8, 120)   # SwinIR-light: embed 60, 6 heads of 10, mlp 2
# past the joint kernel's widths: heads of 60, and SwinIR-L's 240 in 8 heads of 30; mlp 2
WIDE_WIDTHS = ((180, 3, 8, 360), (240, 8, 8, 480))
ROUTE = {torch.float32: '3xTF32 at 495 TFLOP/s', torch.bfloat16: 'bfloat16 at 989 TFLOP/s'}


def tensor_core_bound_ms(flop, nbytes, dtype):
    """(bound ms, by what) of a kernel whose products all run on the tensor
    cores (all but K8, K9): float32 as three TF32 products (3xTF32) at the TF32
    peak, bfloat16 at the bfloat16 peak; and the float32 CUDA-core bound
    (their first route) beside it."""
    peak, products = (PEAK_FLOPS_TF32, 3) if dtype == torch.float32 else (PEAK_FLOPS_BF16, 1)
    by_ops, by_bytes = products * flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = (by_ops, 'operations') if by_ops >= by_bytes else (by_bytes, 'bytes')
    return bound, max(flop / PEAK_FLOPS_F32 * 1e3, by_bytes)


def kernel_work(kernel, b, h, w, dtype, shifted, widths=M_WIDTHS):
    """(FLOP, bytes) of one call on a Swin block (SwinIR-M's widths unless
    given): every product of the function, each input read once and each
    output written once."""
    c, heads, ws, hid = widths
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    attn_w, mlp_w = 4 * c * c, 2 * c * hid                      # weight elements
    small = 4 * (8 * c + hid) + 4 * heads * n * n               # LN, biases, rel_bias (f32)
    mask = 4 * (h // ws) * (w // ws) * n * n if shifted else 0
    attn_fwd = t * (8 * c * c + 4 * n * c)
    mlp_fwd = t * 4 * c * hid
    return {
        'swin_block_joint_fwd': (attn_fwd + mlp_fwd,
                                 2 * t * c * es + (attn_w + mlp_w) * es + small + mask),
        'swin_attn_block_fwd': (attn_fwd, 2 * t * c * es + attn_w * es + small + mask),
        # recomputes qkv, scores and P v; then dWproj, dO, dV, dP, dQ, dK, dWqkv, dLN
        'swin_attn_block_bwd': (t * (22 * c * c + 12 * n * c),
                                3 * t * c * es + attn_w * (es + 4) + 2 * small + mask),
        'mlp_block_fwd': (mlp_fwd, 2 * t * c * es + mlp_w * es + small),
        # recomputes fc1; then dW2, dh, dW1, dLN
        'mlp_block_bwd': (t * 10 * c * hid, 3 * t * c * es + mlp_w * (es + 4) + 2 * small),
    }[kernel]


def compare(got, want, dtype, rule):
    """(ok, max abs err, max abs err / max|plain|, the tolerance in words)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return False, float('nan'), float('nan'), 'finite'
    err = (got - want).abs()
    max_abs = err.max().item()
    max_rel = max_abs / max(want.abs().max().item(), 1e-30)
    if dtype != torch.float32:
        return max_rel <= BF16_TOL, max_abs, max_rel, f'max|err| <= {BF16_TOL} max|plain|'
    if rule == 'elementwise':
        ok = bool((err <= F32_TOL[0] + F32_TOL[1] * want.abs()).all())
        return ok, max_abs, max_rel, f'|err| <= {F32_TOL[0]} + {F32_TOL[1]} |plain|'
    return max_rel <= F32_SUM_TOL, max_abs, max_rel, f'max|err| <= {F32_SUM_TOL} max|plain|'


def time_pair(plain, kernel):
    """(kernel ms, plain ms), timed in the order plain, kernel, kernel, plain."""
    times = [cuda_time_ms(fn) for fn in (plain, kernel, kernel, plain)]
    return (times[1] + times[2]) / 2, (times[0] + times[3]) / 2


def check_joint_kernel():
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full, reference_swin_block_full
    phase('3a. joint forward kernel vs plain version (SwinIR-M block: C=180, 6 heads, '
          'window 8, hidden 360)')
    gen = torch.Generator().manual_seed(0)
    both = (torch.float32, torch.bfloat16)
    cases = [(2, 64, 64, dt, shift, False) for dt in both for shift in (0, 4)]
    # the padded shapes of the served requests, one image each
    cases += [(1, h + (-h) % 8, w + (-w) % 8, torch.float32, 4, False) for h, w in LQ_SIZES]
    # the joint training route's call: a batch of patches under DropPath's scales
    cases += [(*TRAIN_SHAPE, dt, shift, True) for dt in both for shift in (0, 4)]
    cases = [case + (M_WIDTHS,) for case in cases]
    # SwinIR-light's widths (head dim 10), and a window of 16 tokens
    cases += [(2, 64, 64, dt, shift, False, LIGHT_WIDTHS) for dt in both for shift in (0, 4)]
    cases += [(2, 32, 32, dt, shift, False, (C, HEADS, 4, HIDDEN))
              for dt in both for shift in (0, 2)]
    summary = {'max_abs_err': 0.}
    for b, h, w, dt, shift, scaled, (c, heads, ws, hidden) in cases:
        args = block_inputs(b, h, w, dt, shift, gen, c, heads, ws, hidden)
        scales = None
        if scaled:   # mask / keep per sample and branch: sample 1 loses both, sample 2 one
            s1 = torch.full((b,), 1 / 0.9, device='cuda')
            s2 = torch.full((b,), 1 / 0.8, device='cuda')
            s1[1] = s2[1] = s2[2] = 0.
            scales = (s1, s2)
        with torch.no_grad():
            got = fused_swin_block_full(*args, residual_scales=scales)
            want = reference_swin_block_full(*args, residual_scales=scales)
        torch.cuda.synchronize()
        ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
        if scaled and not torch.equal(got[1], args[0][1]):
            fail(f'joint kernel: a dropped sample is not passed through at {(b, h, w, dt, shift)}')
        widths = '' if (c, heads, ws, hidden) == M_WIDTHS else f' C={c} heads={heads} ws={ws}'
        line = (f'B={b} {h}x{w}{widths} {str(dt)[6:]:8s} shift={shift}{" scaled" if scaled else ""}: '
                f'max_abs_err={max_abs:.3e} '
                f'max_rel_err={max_rel:.3e} (max|err| / max|plain|), tolerance {tolerance}')
        with torch.no_grad():
            kernel_ms, plain_ms = time_pair(
                lambda: reference_swin_block_full(*args, residual_scales=scales),
                lambda: fused_swin_block_full(*args, residual_scales=scales))
        line += f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms'
        if (c, heads, ws, hidden) == M_WIDTHS and (
                (b, h, w) == (1, 128, 128) or (b, h, w, dt) == (2, 64, 64, torch.bfloat16)):
            flop, nbytes = kernel_work('swin_block_joint_fwd', b, h, w, dt, shift)
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            line += (f', bound {bound:.4f} ms by {by} on its route ({ROUTE[dt]}; on the CUDA '
                     f'cores {cuda_cores:.4f} ms)')
            if (b, h, w, dt) == (1, 128, 128, torch.float32):   # the largest served request
                summary.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                               cuda_core_bound_ms=cuda_cores)
        print(line, flush=True)
        if not ok:
            fail(f'joint kernel and plain version disagree at {(b, h, w, dt, shift, scaled)}')
        if dt == torch.float32:
            summary['max_abs_err'] = max(summary['max_abs_err'], max_abs)
    return summary


ATTN_GRADS = ('dx', 'd_ln_weight', 'd_ln_bias', 'd_qkv_weight', 'd_qkv_bias', 'd_proj_weight',
              'd_proj_bias', 'd_rel_bias')
MLP_GRADS = ('dx', 'd_ln_weight', 'd_ln_bias', 'd_fc1_weight', 'd_fc1_bias', 'd_fc2_weight',
             'd_fc2_bias')
TRAIN_SHAPE = (4, 48, 48)   # batch 4 of 48x48 LQ patches: the training step's block input


def check_branch_kernels():
    """The four kernels of the training path against their plain versions."""
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    phase('3b. attention and MLP branch kernels, forward and backward, vs plain versions')
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    cases = [(shape, torch.float32, shift, mode, M_WIDTHS) for shape in (TRAIN_SHAPE, (2, 64, 64))
             for shift in (0, 4) for mode in ('branch', 'residual', 'scaled')]
    cases += [(TRAIN_SHAPE, torch.bfloat16, 4, mode, M_WIDTHS)
              for mode in ('branch', 'residual', 'scaled')]
    # the attention kernels where their tiles are padded: SwinIR-light's
    # heads of 10 features, windows of 16 tokens, and heads of 48 features
    # (two 32-feature chunks of a head, wider than the joint kernel takes)
    both = (torch.float32, torch.bfloat16)
    cases += [((2, 64, 64), dt, 4, 'scaled', LIGHT_WIDTHS) for dt in both]
    cases += [((2, 32, 32), dt, 2, mode, (C, HEADS, 4, HIDDEN))
              for dt in both for mode in ('branch', 'scaled')]
    cases += [((2, 64, 64), torch.float32, 4, 'residual', (96, 2, WS, 192))]
    # a token count that is not a multiple of the MLP kernels' 64-token tile
    # (480, the last tile half full and across two samples): not whole
    # windows, so the MLP kernels alone
    cases += [((2, 20, 12), dt, 0, 'scaled', M_WIDTHS) for dt in both]
    # SwinIR's eval blocks past the joint kernel's widths (phase 22): the
    # forward kernels alone
    cases += [((2, 64, 64), dt, 4, 'scaled', widths) for widths in WIDE_WIDTHS for dt in both]
    padded_s = 0.
    summary = {name: {'max_abs_err': 0.} for name in
               ('swin_attn_block_fwd', 'swin_attn_block_bwd', 'mlp_block_fwd', 'mlp_block_bwd')}
    for (b, h, w), dt, shift, mode, widths in cases:
        t_case = time.perf_counter()
        c, heads, ws, hidden = widths
        (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ln2w, ln2b, w1, b1, w2, b2,
         ws, heads, scale) = block_inputs(b, h, w, dt, shift, gen, c, heads, ws, hidden)
        dz = torch.randn(x.shape, generator=gen).cuda().to(dt)
        add = mode == 'residual'
        s = None
        if mode == 'scaled':   # DropPath's mask / keep: one sample dropped
            s = torch.full((b,), 1 / 0.9, device='cuda')
            s[1] = 0.
        tail = (add, s)
        attn = (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ws, heads, scale) + tail
        attn_b = (x, dz, ln1w, ln1b, wqkv, bqkv, wproj, rel, mask, ws, heads, scale) + tail
        mlp = (x, ln2w, ln2b, w1, b1, w2, b2) + tail
        mlp_b = (x, dz, ln2w, ln2b, w1, b1, w2) + tail
        runs = [
            ('swin_attn_block_fwd', S.swin_attn_block_forward, S.reference_swin_attn_block,
             attn, ('out',)),
            ('swin_attn_block_bwd', S.swin_attn_block_backward,
             S.reference_swin_attn_block_backward, attn_b, ATTN_GRADS),
            ('mlp_block_fwd', M.mlp_block_forward, M.reference_mlp_block, mlp, ('out',)),
            ('mlp_block_bwd', M.mlp_block_backward, M.reference_mlp_block_backward, mlp_b,
             MLP_GRADS),
        ]
        padded = widths != M_WIDTHS or h % ws or w % ws
        if h % ws or w % ws:
            runs = runs[2:]
        elif widths in WIDE_WIDTHS:   # the eval route: the forward kernels
            runs = runs[0:1] + runs[2:3]
        elif widths not in (M_WIDTHS, LIGHT_WIDTHS):   # the MLP kernels' tiles are not padded
            runs = runs[:2]
        tag = (f'B={b} {h}x{w} {str(dt)[6:]:8s} shift={shift} {mode:8s}'
               + ('' if widths == M_WIDTHS else f' C={c} heads={heads} ws={ws}'))
        for name, kernel, plain, args, outputs in runs:
            with torch.no_grad():
                got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g, wnt in zip(outputs, got, want):
                # activations elementwise; parameter gradients, sums over all
                # tokens, relative to the largest entry
                rule = 'elementwise' if out_name in ('out', 'dx') else 'sum'
                ok, max_abs, max_rel, tolerance = compare(g, wnt, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    print(f'{name} {tag}: ' + ', '.join(worst))
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == torch.float32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            if mode == 'scaled':   # a dropped sample passes x and dz through untouched
                through = dz if name.endswith('bwd') else x
                if not torch.equal(got[0][1], through[1]):
                    fail(f'{name}: the dropped sample is not passed through at {tag}')
            kernel_ms, plain_ms = time_pair(lambda: plain(*args), lambda: kernel(*args))
            flop, nbytes = kernel_work(name, b, h, w, dt, shift, widths)
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            route = (f'bound {bound:.4f} ms by {by} on its route ({ROUTE[dt]}; on the CUDA '
                     f'cores {cuda_cores:.4f} ms)')
            print(f'{name:20s} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                  f'{route} | max abs err (of max|plain|): ' + ', '.join(worst), flush=True)
            main_case = ((b, h, w), shift, mode, widths) == (TRAIN_SHAPE, 4, 'scaled', M_WIDTHS)
            if main_case and dt == torch.bfloat16:
                summary[name].update(bf16_ms=kernel_ms, bf16_bound_ms=bound)
            if main_case and dt == torch.float32:
                summary[name].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, cuda_core_bound_ms=cuda_cores)
                if name == 'mlp_block_fwd':   # its grid: units, parts, blocks an SM, SMs
                    units, parts, per_sm, sms, _ = M.forward_plan(x, hidden)
                    fill = units / (-(-units // (per_sm * sms)) * per_sm * sms)
                    print(f'{name:20s} {tag}: grid {units} units (64-token tiles x {parts} '
                          f'parts of the hidden chunks), {per_sm} block(s) an SM on {sms} SMs, '
                          f'{100 * fill:.1f}% of the waves\' slots filled', flush=True)
                    summary[name].update(units=units, parts=parts, fill=fill)
                if name == 'swin_attn_block_fwd':   # device time of its two launches
                    with torch.no_grad():
                        split = {part: kernel_device_ms(lambda: kernel(*args),
                                                        only=f'swin_attn_fwd_{part}_kernel')
                                 for part in ('head', 'proj')}
                    print(f'{name:20s} {tag}: device time of the (window, head) units '
                          f'{show_ms(split["head"])}, of proj {show_ms(split["proj"])}', flush=True)
                    summary[name].update({f'{part}_device_ms': ms for part, ms in split.items()})
                if name.endswith('bwd'):   # atomicAdd sums: reported, not required
                    with torch.no_grad():
                        again = kernel(*args)
                    print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit '
                          'for bit: ' + ', '.join(
                              f'{o} {"yes" if torch.equal(g, a) else "no"}'
                              for o, g, a in zip(outputs, got, again)), flush=True)
            if name.endswith('fwd') and mode == 'scaled':   # K2, K4: no atomics, required
                with torch.no_grad():
                    again = kernel(*args)
                if not torch.equal(got[0], again):
                    fail(f'{name}: a second launch on the same inputs differs at {tag}')
                print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit for bit',
                      flush=True)
        if padded:
            padded_s += time.perf_counter() - t_case
    print(f'phase 3b: {time.perf_counter() - t0:.1f} s, of which {padded_s:.1f} s for the '
          'padded shapes (C=60, window 4, C=96, 20x12)')
    return summary


RS_C, RS_HEADS = 192, 6   # the Swin layers of the ResShift UNets: 6 heads of 32
# the RS fork's own diffusion config: UNetModelSwin with window 9 (81 tokens)
# on 72x72 latents (GT 288 through the VQ-f4 first stage), attention at 72,
# 36, 18 and 9, batch 32 under use_amp
L2S_CONFIG = 'options/train/ResShift/train_ResShift_L2S288.yml'
ATTENTION_KERNELS = ('window_attention_fwd', 'window_attention_bwd')


def attention_work(kernel, b, h, w, c, heads, nwb, dtype, ws):
    """(FLOP, bytes) of one window-attention call: the two products of the
    forward (4 n C a token) or the five of the backward (10 n C, the scores
    recomputed), qkv (and dout) read once, out (or dqkv) written once, the
    float32 bias read and, in the backward, dbias written."""
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    bias = 4 * nwb * heads * n * n
    return {'window_attention_fwd': (t * 4 * n * c, t * 4 * c * es + bias),
            'window_attention_bwd': (t * 10 * n * c, t * 7 * c * es + 2 * bias)}[kernel]


def sdpa_window_attention(qkv, mask, ws, heads, scale):
    """The one library call that computes the forward kernel's function,
    ``F.scaled_dot_product_attention`` with the float bias as ``attn_mask``,
    between the window partition and reverse copies it needs. Timed here as a
    yardstick; the port never calls it."""
    import torch.nn.functional as F
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    x = qkv.reshape(b, h // ws, ws, w // ws, ws, 3, heads, c // heads)
    q, k, v = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, ws * ws, c // heads)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    o = o.reshape(b, h // ws, w // ws, heads, ws, ws, c // heads)
    return o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)


def sdpa_window_attention_backward(qkv, bias, dout, ws, heads, scale):
    """The library's counterpart of the backward kernel: (dqkv, dbias) by
    ``torch.autograd.grad`` through ``sdpa_window_attention``, the float
    bias (nWb, heads, n, n) a leaf repeated over the samples, so that its
    gradient is summed back over them; and a function that reruns that
    backward alone on the same forward's graph. Timed here as a yardstick;
    the port never calls it."""
    qkv_leaf = qkv.detach().requires_grad_()
    bias_leaf = bias.detach().to(qkv.dtype).requires_grad_()
    with torch.enable_grad():
        out = sdpa_window_attention(qkv_leaf, bias_leaf.repeat(qkv.shape[0], 1, 1, 1), ws,
                                    heads, scale)

    def backward():
        return torch.autograd.grad(out, (qkv_leaf, bias_leaf), dout, retain_graph=True)

    return backward(), backward


def check_attention_kernels(train_batch, l2s_batch):
    """The window-attention kernels, forward and backward, against their
    plain versions at the shapes the ResShift UNets give them: window 8
    (the published RGB config) and window 9 (``L2S_CONFIG``, whose batch under
    use_amp is ``l2s_batch``; float32 at half of it)."""
    from basicsr4rs_torch.archs.unet_arch import shift_attn_mask_resshift
    from basicsr4rs_torch.ops import window_attention as A
    phase('3c. window attention kernels, forward and backward, vs plain versions '
          f'(C={RS_C}, {RS_HEADS} heads; window {WS}, and window 9 on the 72x72 latents of '
          f'{os.path.basename(L2S_CONFIG)}; and C={C}, head_dim {C // HEADS})')
    gen = torch.Generator().manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H = W, C, dtype, shifted, window)
    serve_case, train_case = (1, 64, RS_C, f32, True, WS), (train_batch, 64, RS_C, f32, True, WS)
    bf16_case = (train_batch, 64, RS_C, bf16, True, WS)
    l2s_case, l2s_bf16_case = (l2s_batch // 2, 72, RS_C, f32, True, 9), (l2s_batch, 72, RS_C,
                                                                         bf16, True, 9)
    cases = [serve_case, (1, 64, RS_C, f32, False, WS), (1, 8, RS_C, f32, False, WS), train_case,
             (train_batch, 64, RS_C, f32, False, WS), (train_batch, 32, RS_C, f32, True, WS),
             (train_batch, 16, RS_C, f32, True, WS), (train_batch, 8, RS_C, f32, False, WS),
             bf16_case, (train_batch, 64, RS_C, bf16, False, WS), (1, 64, RS_C, bf16, True, WS),
             (2, 64, C, f32, True, WS), (2, 64, C, bf16, False, WS)]
    for b, dt in ((l2s_batch // 2, f32), (l2s_batch, bf16)):   # 72, 36, 18 shifted by 4; 9 alone
        cases += [(b, size, RS_C, dt, size > 9, 9) for size in (72, 36, 18, 9)]
    library_backward = {train_case: '', bf16_case: 'bf16_', l2s_case: 'window9_',
                        l2s_bf16_case: 'window9_bf16_'}
    summary = {name: {'max_abs_err': 0., 'library_ms': None} for name in ATTENTION_KERNELS}
    t0 = time.perf_counter()
    for case in cases:
        b, size, c, dt, shifted, ws = case
        heads, n = HEADS, ws * ws
        scale = (c // heads)**-.5
        qkv = torch.randn(b, size, size, 3 * c, generator=gen).cuda().to(dt)
        dout = torch.randn(b, size, size, c, generator=gen).cuda().to(dt)
        bias = (torch.randn(1, heads, n, n, generator=gen) * .5).cuda()
        if shifted:
            mask = torch.from_numpy(shift_attn_mask_resshift(size, size, ws, ws // 2)).cuda()
            bias = bias + mask[:, None]
        nwb = bias.shape[0]
        args = (qkv, bias, ws, heads, scale)
        args_b = (qkv, bias, dout, ws, heads, scale)
        tag = f'B={b} {size}x{size} C={c} ws={ws} {str(dt)[6:]:8s} nWb={nwb}'
        runs = [('window_attention_fwd', A.window_attention_forward,
                 A.reference_window_attention, args, ('out',)),
                ('window_attention_bwd', A.window_attention_backward,
                 A.reference_window_attention_backward, args_b, ('dqkv', 'dbias'))]
        for name, kernel, plain, call, outputs in runs:
            with torch.no_grad():
                got = kernel(*call)
            want = plain(*call)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g_, w_ in zip(outputs, got, want):
                # dbias is a sum over samples (and windows); activations elementwise
                rule = 'sum' if out_name == 'dbias' else 'elementwise'
                ok, max_abs, max_rel, tolerance = compare(g_, w_, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == f32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            with torch.no_grad():
                kernel_ms, plain_ms = time_pair(lambda: plain(*call), lambda: kernel(*call))
            flop, nbytes = attention_work(name, b, size, size, c, heads, nwb, dt, ws)
            # every product on the tensor cores; the unit plan the kernel launched
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            plan = A.forward_plan if name == 'window_attention_fwd' else A.backward_plan
            units, group, per_sm, sms, stages = plan(qkv, ws, heads)
            waves = -(-units // (per_sm * sms))
            line = (f'{name:20s} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                    f'bound {bound:.4f} ms by {by} ({ROUTE[dt]}; CUDA-core {cuda_cores:.4f}); '
                    f'{units} units of {group} samples, {per_sm} an SM ({stages} stages): '
                    f'{waves} waves, {100 * units / (waves * per_sm * sms):.1f}% filled')
            library_ms = None
            if name == 'window_attention_fwd':
                windows = (size // ws)**2
                mask = bias.to(dt) if nwb == 1 else bias.to(dt).repeat(b, 1, 1, 1)
                with torch.no_grad():
                    lib_out = sdpa_window_attention(qkv, mask, ws, heads, scale)
                    ok, max_abs, _, _ = compare(lib_out, want[0], dt, 'elementwise')
                    if not ok:
                        fail(f'the library call disagrees with the plain version at {tag}: '
                             f'{max_abs:.3e}')
                    library_ms = cuda_time_ms(
                        lambda: sdpa_window_attention(qkv, mask, ws, heads, scale))
                line += (f', library (SDPA + partition/reverse copies, {b * windows} windows) '
                         f'{library_ms:.4f} ms')
                key = {l2s_case: 'window9_', l2s_bf16_case: 'window9_bf16_', train_case: 'train_',
                       bf16_case: 'bf16_'}.get(case)
                if key:
                    summary[name].update({f'{key}ms': kernel_ms, f'{key}bound_ms': bound,
                                          f'{key}library_ms': library_ms})
            elif case in library_backward:   # the backward of that call, the forward untimed
                lib_grads, backward = sdpa_window_attention_backward(*args_b)
                for out_name, g_, w_ in zip(outputs, lib_grads, want):
                    ok, max_abs, _, _ = compare(g_, w_, dt,
                                                'sum' if out_name == 'dbias' else 'elementwise')
                    if not ok:
                        fail(f'the library backward disagrees with the plain version at {tag}: '
                             f'{out_name} {max_abs:.3e}')
                library_ms = cuda_time_ms(backward)
                del lib_grads, backward
                line += (f', library (autograd.grad through SDPA + partition/reverse copies, '
                         f'dqkv and dbias) {library_ms:.4f} ms')
                key = library_backward[case]
                if key:
                    summary[name].update({f'{key}ms': kernel_ms, f'{key}bound_ms': bound,
                                          f'{key}library_ms': library_ms})
            if case == serve_case and name == 'window_attention_fwd':   # a call of a request
                with torch.no_grad():
                    device_ms = kernel_device_ms(lambda: kernel(*call),
                                                 only='window_attention_fwd_kernel')
                    call_us = host_us(lambda: kernel(*call))
                line += f'; device {show_ms(device_ms)}, host {call_us:.1f} us a call'
                summary[name].update(device_ms=device_ms, host_us=call_us)
            print(line + ' | max abs err (of max|plain|): ' + ', '.join(worst), flush=True)
            main_case = serve_case if name == 'window_attention_fwd' else train_case
            if case == main_case:
                summary[name].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, library_ms=library_ms)
            if name == 'window_attention_bwd' and case in (train_case, train_case[:4] + (False, WS)):
                with torch.no_grad():   # atomicAdd sums: reported, not required
                    again = kernel(*call)
                print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit for '
                      'bit: ' + ', '.join(f'{o} {"yes" if torch.equal(g_, a) else "no"}'
                                          for o, g_, a in zip(outputs, got, again)), flush=True)
    print(f'phase 3c: {time.perf_counter() - t0:.1f} s')
    return summary


# ------------------------------------------------- the deformable sampler
DEFORM_KERNELS = ('deform_sample_fwd', 'deform_sample_bwd')
EDVR_FEAT, EDVR_GROUPS, EDVR_FRAMES = 64, 8, 5          # EDVR-M: num_feat, deformable_groups
EDVR_TRAIN_BATCH, EDVR_TRAIN_LQ = 4, 64                 # GT 256 at x4
VIDEO_LQ = (180, 320)                                   # the REDS4 frame at x4
PP_FEAT, PP_GROUPS = 64, 16                             # BasicVSR++: mid_channels, deform groups


def deform_work(kernel, n, c, h, w, taps, groups, with_mask, dtype):
    """(FLOP, bytes) of one sampler call with stride 1 and 'same' padding:
    the map, offsets and mask read once, the column tensor written once (or
    read once, with the three gradients written); 8 operations a sample for
    the blend and the mask, 30 in the backward, 20 a tap for its position."""
    es, p = torch.finfo(dtype).bits // 8, h * w
    maps, col = n * c * p * es, n * c * taps * p * es
    offsets = n * groups * taps * p * 4 * (3 if with_mask else 2)
    position = 20 * n * groups * taps * p
    return {'deform_sample_fwd': (8 * n * c * taps * p + position, maps + offsets + col),
            'deform_sample_bwd': (30 * n * c * taps * p + 2 * position,
                                  2 * maps + 2 * offsets + col)}[kernel]


def deform_inputs(n, c, h, w, taps, groups, with_mask, dtype, spread, gen):
    """A map, offsets and a mask on the card. ``spread`` is the offsets'
    standard deviation in pixels; the first sample's offsets are whole
    numbers, a tenth of them zero."""
    from basicsr4rs_torch.ops.dcn import SampleGeometry
    k = 3 if taps == 9 else 1
    geo = SampleGeometry(k, k, 1, k // 2, 1, groups)
    x = torch.randn(n, c, h, w, generator=gen).cuda().to(dtype)
    offset = torch.randn(n, groups * 2 * taps, h, w, generator=gen) * spread
    offset[0] = offset[0].round() * (torch.rand(offset[0].shape, generator=gen) > .1)
    mask = torch.rand(n, groups * taps, h, w, generator=gen).cuda() if with_mask else None
    dcol = torch.randn(n, c, taps, h, w, generator=gen).cuda().to(dtype)
    return x, offset.cuda(), mask, dcol, geo


def grid_of(offset):
    """``F.grid_sample``'s normalised grid for a one-tap offset (dy, dx)."""
    n, _, h, w = offset.shape
    ys = torch.arange(h, device=offset.device).view(1, h, 1) + offset[:, 0]
    xs = torch.arange(w, device=offset.device).view(1, 1, w) + offset[:, 1]
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)


def check_deform_kernels():
    """The deformable sampler's kernels against their plain versions at the
    shapes EDVR-M and BasicVSR++ give them, nine taps and one."""
    import torch.nn.functional as F

    from basicsr4rs_torch.ops import dcn as D
    phase('3d. deformable sampler kernels, forward and backward, vs plain versions')
    gen = torch.Generator().manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    tb, tl, (sh, sw) = EDVR_TRAIN_BATCH * EDVR_FRAMES, EDVR_TRAIN_LQ, VIDEO_LQ
    edvr = (EDVR_FEAT, 9, EDVR_GROUPS, True)
    pp = (2 * PP_FEAT, 9, PP_GROUPS, True)
    # (tag, N, H, W, (C, taps, deform groups, mask), dtype, offset spread, timed)
    train_case = ('EDVR train L1', tb, tl, tl, edvr, f32, 2., True)
    warp_case = ('warp 64ch zeros', 1, 64, 64, (PP_FEAT, 1, 1, False), f32, 3., True)
    cases = [train_case,
             ('EDVR train L2', tb, tl // 2, tl // 2, edvr, f32, 2., False),
             ('EDVR train L3', tb, tl // 4, tl // 4, edvr, f32, 12., False),
             ('EDVR train L1 bf16', tb, tl, tl, edvr, bf16, 2., False),
             ('EDVR serve L1', EDVR_FRAMES, sh, sw, edvr, f32, 2., True),
             ('EDVR serve L2', EDVR_FRAMES, sh // 2, sw // 2, edvr, f32, 40., False),
             ('EDVR serve L3', EDVR_FRAMES, sh // 4, sw // 4, edvr, f32, 2., False),
             ('EDVR serve L1 bf16', EDVR_FRAMES, sh, sw, edvr, bf16, 2., False),
             ('BasicVSR++ train', 1, 64, 64, pp, f32, 4., True),
             ('BasicVSR++ train far', 1, 64, 64, pp, f32, 40., False),
             ('BasicVSR++ serve', 1, sh, sw, pp, f32, 4., True),
             ('BasicVSR++ train bf16', 1, 64, 64, pp, bf16, 4., False),
             warp_case,
             ('warp 64ch serve', 1, sh, sw, (PP_FEAT, 1, 1, False), f32, 3., True),
             ('warp 2ch flow', 1, 64, 64, (2, 1, 1, False), f32, 30., False),
             ('warp 3ch SpyNet', 58, 64, 64, (3, 1, 1, False), f32, 3., False),
             ('warp 64ch bf16', 1, 64, 64, (PP_FEAT, 1, 1, False), bf16, 3., False)]
    summary = {name: {'max_abs_err': 0., 'library_ms': None} for name in DEFORM_KERNELS}
    for case in cases:
        tag, n, h, w, (c, taps, groups, with_mask), dt, spread, timed = case
        x, offset, mask, dcol, geo = deform_inputs(n, c, h, w, taps, groups, with_mask, dt,
                                                   spread, gen)
        outside = 1 - D.reference_deform_sample(torch.ones(n, groups, h, w, device='cuda'),
                                                offset, None, geo).ne(0).float().mean().item()
        tag = (f'{tag:22s} N={n} C={c} {h}x{w} K={taps} G={groups} {str(dt)[6:]:8s} '
               f'({100 * outside:.1f}% of the samples outside)')
        runs = [('deform_sample_fwd', lambda: D.deform_sample_forward(x, offset, mask, geo),
                 lambda: D.reference_deform_sample(x, offset, mask, geo), ('col',)),
                ('deform_sample_bwd', lambda: D.deform_sample_backward(x, offset, mask, dcol, geo),
                 lambda: D.reference_deform_sample_backward(x, offset, mask, dcol, geo),
                 ('dx', 'doffset', 'dmask'))]
        for name, kernel, plain, outputs in runs:
            with torch.no_grad():
                got = kernel()
            want = plain()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g_, w_ in zip(outputs, got, want):
                if w_ is None:
                    if g_ is not None:
                        fail(f'{name}: {out_name} without a mask at {tag}')
                    continue
                # the column tensor is elementwise; the gradients are sums (dx over the
                # samples that touch a pixel, by atomicAdd; the others over a group's channels)
                rule = 'elementwise' if out_name == 'col' else 'sum'
                ok, max_abs, max_rel, tolerance = compare(g_, w_, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == f32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            line = f'{name:18s} {tag}: max abs err (of max|plain|) ' + ', '.join(worst)
            del got, want
            if timed:
                with torch.no_grad():
                    kernel_ms = cuda_time_ms(kernel, iters=5)
                plain_ms = cuda_time_ms(plain, iters=2)
                with torch.no_grad():
                    kernel_ms = (kernel_ms + cuda_time_ms(kernel, iters=5)) / 2
                flop, nbytes = deform_work(name, n, c, h, w, taps, groups, with_mask, dt)
                bound, by = bound_ms(flop, nbytes, dt)
                line += (f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                         f'{bound:.4f} ms by {by}')
                times = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
                if taps == 1:   # the library's call for the same warp, as a yardstick
                    grid = grid_of(offset)
                    if name == 'deform_sample_fwd':
                        def call():
                            return F.grid_sample(x, grid, 'bilinear', 'zeros', True)
                        with torch.no_grad():
                            lib = call().unsqueeze(2)
                            want = plain()
                    else:
                        xg, gg = x.clone().requires_grad_(), grid.clone().requires_grad_()
                        out = F.grid_sample(xg, gg, 'bilinear', 'zeros', True)

                        def call():
                            return torch.autograd.grad(out, (xg, gg), dcol[:, :, 0],
                                                       retain_graph=True)
                        lib, want = call()[0], plain()[0]
                    ok, max_abs, max_rel, _ = compare(lib, want, dt, 'sum')
                    if max_rel > 1e-3:   # it blends on the normalised grid: a looser check
                        fail(f'F.grid_sample disagrees with the plain version at {tag}: '
                             f'{max_abs:.3e}')
                    times['library_ms'] = cuda_time_ms(call, iters=5)
                    line += f', library (F.grid_sample) {times["library_ms"]:.4f} ms'
                    if case == warp_case:
                        summary[name]['one_tap'] = times
                if case == train_case:
                    summary[name].update(times)
            print(line, flush=True)
            if name == 'deform_sample_bwd' and timed:
                with torch.no_grad():   # atomicAdd sums: reported, not required
                    first, again = kernel(), kernel()
                print(f'{name:18s} {tag}: a second launch on the same inputs repeats bit for '
                      'bit: ' + ', '.join(f'{o} {"yes" if torch.equal(a, b) else "no"}'
                                          for o, a, b in zip(outputs, first, again)
                                          if a is not None), flush=True)
        del x, offset, mask, dcol
        torch.cuda.empty_cache()
    check_flow_warps(gen, summary)
    check_border_warp(gen)
    return summary


def kernel_device_ms(fn, iters=20, only=None):
    """Milliseconds of device time (kernels and memory operations; with
    ``only``, those whose name holds it) a call of ``fn`` takes, by
    ``torch.profiler`` over ``iters`` calls; None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_time_by_group(prof, ())[0]
    busy_ms = sum(ms for key, ms, _ in rows if only is None or only in key)
    return busy_ms / iters if busy_ms else None


def show_ms(ms):
    return 'not seen' if ms is None else f'{ms:.4f} ms'


def host_us(fn, iters=200):
    """Microseconds of host time a call of ``fn`` takes, the device kept
    ahead of the host by a long kernel first."""
    torch.cuda._sleep(int(2e8))   # about 0.1 s of device time, so nothing waits on it
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def check_flow_warps(gen, summary):
    """The one-tap warp as ``flow_warp`` runs it in 'zeros' mode: the flow
    (N, H, W, 2) read by the kernel through its strides, handed over as
    BasicVSR++ does (a permuted (N, 2, H, W) map), against the plain version
    on BasicSR's offset; then the call time (CUDA events around the
    wrapper) and the kernel's device time (``torch.profiler``) beside
    ``F.grid_sample``'s, so that what is left between them reads as host or
    device time; and the gradients of ``flow_warp`` against the plain
    versions."""
    import torch.nn.functional as F

    from basicsr4rs_torch.archs.arch_util import flow_warp
    from basicsr4rs_torch.ops import dcn as D
    f32 = torch.float32
    for tag, c, (h, w) in (('warp 64ch flow', PP_FEAT, (64, 64)),
                           ('warp 64ch flow serve', PP_FEAT, VIDEO_LQ),
                           ('warp 2ch flow', 2, (64, 64))):
        x = torch.randn(1, c, h, w, generator=gen).cuda()
        flow = (torch.randn(1, 2, h, w, generator=gen) * 3.).cuda().permute(0, 2, 3, 1)
        offset = torch.stack([flow[..., 1], flow[..., 0]], dim=1)   # BasicSR's (dy, dx)
        with torch.no_grad():
            got = D.warp_by_flow(x, flow)
        want = D.reference_deform_sample(x, offset, None, D.WARP).reshape(x.shape)
        ok, max_abs, max_rel, tolerance = compare(got, want, f32, 'elementwise')
        if not ok:
            fail(f'deform_sample_fwd: the flow warp disagrees with the plain version at {tag}: '
                 f'{max_abs:.3e}, tolerance {tolerance}')
        summary['deform_sample_fwd']['max_abs_err'] = max(
            summary['deform_sample_fwd']['max_abs_err'], max_abs)
        grid = grid_of(offset)

        def kernel():
            return D.warp_by_flow(x, flow)

        def library():
            return F.grid_sample(x, grid, 'bilinear', 'zeros', True)

        col = torch.empty(1, c, 1, h, w, device='cuda')
        lib = D._lib('deform_sample_fwd')
        launch_args = (0, x.data_ptr(), flow.data_ptr(), None, col.data_ptr(),
                       D._forward_dims(x.shape, D.FLOW_WARP, flow.shape, flow.stride())[1],
                       torch.cuda.current_stream().cuda_stream)

        def launch_only():   # the C call alone: ctypes and the kernel's launch
            return lib.deform_sample_fwd(*launch_args)

        with torch.no_grad():
            kernel_ms, library_ms = time_pair(library, kernel)
            device_ms, library_device_ms = kernel_device_ms(kernel), kernel_device_ms(library)
            wrapper_us, launch_us, library_us = host_us(kernel), host_us(launch_only), host_us(
                library)
        bound, by = bound_ms(*deform_work('deform_sample_fwd', 1, c, h, w, 1, 1, False, f32), f32)

        print(f'{"deform_sample_fwd":18s} {tag:22s} N=1 C={c} {h}x{w} (flow_warp, zeros): max abs '
              f'err {max_abs:.2e} | call {kernel_ms:.4f} ms, device {show_ms(device_ms)}; '
              f'F.grid_sample call {library_ms:.4f} ms, device {show_ms(library_device_ms)}; bound '
              f'{bound:.4f} ms by {by}; host {wrapper_us:.1f} us a call, of which the C call '
              f'(ctypes and launch) {launch_us:.1f} us; F.grid_sample host {library_us:.1f} us',
              flush=True)
        summary['deform_sample_fwd'].setdefault('flow_warp', {})[f'C={c} {h}x{w}'] = dict(
            ms=kernel_ms, device_ms=device_ms, library_ms=library_ms,
            library_device_ms=library_device_ms, bound_ms=bound, host_us=wrapper_us,
            launch_us=launch_us, library_host_us=library_us)
    # gradients of flow_warp's zeros mode, through the kernels and the plain versions
    n, c, h, w = 2, 16, 96, 160
    x = torch.randn(n, c, h, w, generator=gen).cuda()
    flow = (torch.randn(n, 2, h, w, generator=gen) * 20).cuda()
    dout = torch.randn(n, c, h, w, generator=gen).cuda()

    def run():
        xx, ff = x.clone().requires_grad_(), flow.clone().requires_grad_()
        out = flow_warp(xx, ff.permute(0, 2, 3, 1))
        return (out.detach(),) + torch.autograd.grad(out, (xx, ff), dout)

    got = run()
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        want = run()
    finally:
        for p in patches:
            p.stop()
    worst = []
    for name, g_, w_ in zip(('out', 'dx', 'dflow'), got, want):
        ok, max_abs, max_rel, tolerance = compare(g_, w_, f32, 'elementwise' if name == 'out'
                                                  else 'sum')
        worst.append(f'{name} {max_abs:.2e} ({max_rel:.1e})')
        if not ok:
            fail(f'flow_warp (zeros): {name} disagrees with the plain version: {max_abs:.3e}, '
                 f'tolerance {tolerance}')
    print(f'flow_warp zeros       N={n} C={c} {h}x{w}, flow as a permuted (N, 2, H, W) map: '
          'max abs err (of max|plain|) ' + ', '.join(worst), flush=True)


def check_border_warp(gen):
    """``bilinear_warp`` with ``border`` (positions clamped to the map before
    the kernel sees them), forward and backward through the autograd
    function, against the same call on the plain versions."""
    from basicsr4rs_torch.ops import dcn as D
    n, c, h, w = 58, 3, 96, 160   # SpyNet's batch of a 30-frame clip, one level down
    x = torch.randn(n, c, h, w, generator=gen).cuda()
    ys = torch.arange(h).view(1, h, 1) + torch.randn(n, h, w, generator=gen) * 20
    xs = torch.arange(w).view(1, 1, w) + torch.randn(n, h, w, generator=gen) * 20
    dout = torch.randn(n, c, h, w, generator=gen).cuda()

    def run():
        leaves = [t.clone().cuda().requires_grad_() for t in (x, ys, xs)]
        out = D.bilinear_warp(*leaves, border=True)
        return (out.detach(),) + torch.autograd.grad(out, leaves, dout)

    got = run()
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        want = run()
    finally:
        for p in patches:
            p.stop()
    clamped = ((ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)).float().mean().item()
    worst = []
    for name, g_, w_ in zip(('out', 'dx', 'dpy', 'dpx'), got, want):
        ok, max_abs, max_rel, tolerance = compare(g_, w_, torch.float32,
                                                  'elementwise' if name == 'out' else 'sum')
        worst.append(f'{name} {max_abs:.2e} ({max_rel:.1e})')
        if not ok:
            fail(f'bilinear_warp with border: {name} disagrees with the plain version: '
                 f'{max_abs:.3e}, tolerance {tolerance}')
    outside = (ys < 0) | (ys > h - 1)
    if got[2].cpu()[outside].abs().max().item() != 0:
        fail('bilinear_warp with border: a clamped position has a gradient')
    print(f'bilinear_warp border  N={n} C={c} {h}x{w} ({100 * clamped:.1f}% of the positions '
          'clamped, their gradient zero): max abs err (of max|plain|) ' + ', '.join(worst),
          flush=True)


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


def profile_requests(model, loader):
    """Phase 4b: where the device time of the SwinIR-M requests goes, by
    kernel group, two requests of each served size."""
    phase('4b. device time of the SwinIR-M requests by kernel group (torch.profiler)')
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        print(f'LQ {h}x{w}:')
        profile_device_time(model.test, 2, 'request', ('swin_block_joint_kernel',),
                            f'swinir_request_{h}x{w}_profile.json')


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


TRAIN_CONFIG = 'options/train/SwinIR/train_SwinIR_M_x4_synthetic.yml'
TRAIN_DATA_DIR = 'datasets/SwinIR_M_x4_synthetic_train'
TRAIN_IMAGES, TRAIN_GT_SIZE, VAL_LQ_SIZE = 8, 256, 64
RESUME_ITERS = 2
PROFILE_DIR = 'results/chip_smoke'
# whole-model gradients, kernels vs plain versions: per parameter,
# max|difference| <= 1e-3 of the largest entry of the plain gradient (float32
# sums in another order through 36 blocks and 7 convolutions' backward)
GRAD_TOLERANCE = 1e-3


def smooth_image(rng, h, w):
    """A smooth random uint8 image: coarse noise, bicubically enlarged."""
    import cv2
    import numpy as np
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3).astype(np.float32)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_train_inputs():
    """Synthetic GT/LQ pairs for training (8 of GT 256x256, two batches of 4
    at GT patch 192) and one validation pair (LQ 64x64)."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(1)
    sets = [('GT', 'LQ', TRAIN_IMAGES, TRAIN_GT_SIZE), ('val_GT', 'val_LQ', 1, SCALE * VAL_LQ_SIZE)]
    for gt_dir, lq_dir, count, size in sets:
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(TRAIN_DATA_DIR, sub), exist_ok=True)
        for i in range(count):
            gt = smooth_image(rng, size, size)
            lq = cv2.resize(gt, (size // SCALE, size // SCALE), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(TRAIN_DATA_DIR, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(TRAIN_DATA_DIR, lq_dir, f'{i:04d}.png'), lq)


def training_kernels():
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    return {'swin_block_joint_fwd': S.fused_swin_block_full,
            'swin_attn_block_fwd': S.swin_attn_block_forward,
            'swin_attn_block_bwd': S.swin_attn_block_backward,
            'mlp_block_fwd': M.mlp_block_forward, 'mlp_block_bwd': M.mlp_block_backward}


def run_train_pipeline(extra_args, record, config=None, model_cls=None, loss_key='l_pix',
                       wrappers=None, before_first_step=None, after_step=None):
    """``basicsr4rs_torch.train.train_pipeline`` on a synthetic config, with
    every optimization step of ``model_cls`` timed by CUDA events and its
    loss and launch counts recorded; ``after_step(model, step record)`` may
    add to the step's record."""
    import basicsr4rs_torch.train as entry
    from basicsr4rs_torch.models.swinir_model import SwinIRModel
    config = config or TRAIN_CONFIG
    model_cls = model_cls or SwinIRModel
    wrappers = wrappers or training_kernels()
    before_first_step = before_first_step or follow_first_batch
    step = model_cls.optimize_parameters

    def timed_step(model, current_iter):
        if not record['steps']:
            before_first_step(model, record)
        before = {k: w.launches for k, w in wrappers.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(model, current_iter)
        end.record()
        torch.cuda.synchronize()
        record['steps'].append({
            'iter': current_iter, 'ms': start.elapsed_time(end),
            loss_key: float(model.log_dict[loss_key]),
            'launches': {k: w.launches - before[k] for k, w in wrappers.items()}})
        if after_step is not None:
            after_step(model, record['steps'][-1])

    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.train', '-opt', config] + extra_args
    try:
        with mock.patch.object(model_cls, 'optimize_parameters', timed_step):
            return entry.train_pipeline(ROOT)
    finally:
        sys.argv = argv


def follow_first_batch(model, record):
    """Keep SwinIR's first batch: the loss is followed on it."""
    if 'fixed' not in record:
        record['fixed'] = (model.lq.clone(), model.gt.clone())
        record['fixed_loss_before'] = fixed_batch_loss(model, record['fixed'])


def fixed_batch_loss(model, batch):
    """The pixel loss of the training network in eval mode on a fixed batch."""
    lq, gt = batch
    net = model.net_g
    net.eval()
    with torch.no_grad():
        loss = float(model.cri_pix(net(lq), gt))
    net.train()
    return loss


def check_ema_and_checkpoint(model, fresh, ckpt_path):
    """The EMA network has left the trained one, and the saved ``.pth`` holds
    ``params`` and ``params_ema`` that load into ``fresh`` (a new network of
    the same options), ``params_ema`` equal to the EMA network."""
    diff = max((p - e).abs().max().item() for p, e in
               zip(model.net_g.parameters(), model.net_g_ema.parameters()))
    print(f'max |net_g - net_g_ema| over the parameters: {diff:.3e}')
    if not diff > 0:
        fail('the EMA network equals the trained network')
    ckpt = torch.load(ckpt_path, map_location='cpu', weights_only=True)
    if sorted(ckpt) != ['params', 'params_ema']:
        fail(f'{ckpt_path} holds {sorted(ckpt)}')
    for key in ('params', 'params_ema'):
        model.load_network(fresh, ckpt_path, True, key)
    for (name, p), q in zip(fresh.named_parameters(), model.net_g_ema.parameters()):
        if not torch.equal(p, q.cpu()):
            fail(f'{ckpt_path}: params_ema[{name}] differs from the EMA network')
    print(f'{ckpt_path}: params and params_ema load back, params_ema equals the EMA network')


def train():
    import glob
    import shutil

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    phase('6. train SwinIR-M x4 through basicsr4rs_torch.train on cuda:0 '
          '(batch 4, GT 192: 9216 tokens a step)')
    write_train_inputs()
    opt = yaml_load(TRAIN_CONFIG)
    total_iter = opt['train']['total_iter']
    blocks = sum(opt['network_g']['depths'])
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):   # a clean start: no archived copies, no resume
        shutil.rmtree(old)
    wrappers = training_kernels()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline([], record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    steps = record['steps']
    # validation at every val_freq and once more after the loop
    validations = total_iter // opt['val']['val_freq'] + 1
    print(f'pipeline wall time {wall:.3f} s for {len(steps)} steps, {validations} validations, '
          'checkpoints')
    for st in steps:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items() if v))
    if [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'expected steps 1..{total_iter}, ran {[st["iter"] for st in steps]}')
    for st in steps:
        if not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'l_pix is not finite at step {st["iter"]}')
        for name in ('swin_attn_block_fwd', 'swin_attn_block_bwd', 'mlp_block_fwd',
                     'mlp_block_bwd'):
            if st['launches'][name] != blocks:
                fail(f'step {st["iter"]}: {st["launches"][name]} launches of {name}, '
                     f'expected {blocks}')
    # each validation image, and the fixed batch before step 1, is one forward
    # of the joint kernel per block
    if launches['swin_block_joint_fwd'] != blocks * (validations + 1):
        fail(f'{launches["swin_block_joint_fwd"]} launches of the joint kernel, expected '
             f'{blocks} x ({validations} validation images + 1 fixed batch)')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items()))
    timed = [st['ms'] for st in steps[2:]]
    print(f'training step: {sum(timed) / len(timed):.3f} ms mean of steps 3..{total_iter} '
          f'(min {min(timed):.3f}, max {max(timed):.3f}; CUDA events around '
          f'optimize_parameters, after 2 warm-up steps); peak device memory {peak:.1f} MiB')
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before '
          f'step 1, {loss_after:.6f} after step {total_iter} '
          f'(Adam, lr {opt["train"]["optim_g"]["lr"]}, the config\'s)')
    if not loss_after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')

    # EMA, checkpoint, resume
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    check_ema_and_checkpoint(model, SwinIR(**net_opt),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))

    resumed = {'steps': [], 'fixed': record['fixed'], 'fixed_loss_before': 0.}
    # the resumed run also takes its batches through the CUDA prefetcher
    run_train_pipeline(['--auto_resume', '--force_yml',
                        f'train:total_iter={total_iter + RESUME_ITERS}',
                        'datasets:train:prefetch_mode=cuda'], resumed)
    iters = [st['iter'] for st in resumed['steps']]
    print(f'resumed from {total_iter}.state (prefetch_mode: cuda): ran steps {iters}, l_pix '
          + ' '.join(f'{st["l_pix"]:.6f}' for st in resumed['steps']))
    if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
        fail(f'resume should continue at step {total_iter + 1}, ran {iters}')
    profile_training_steps(model, record['fixed'])
    return launches, sum(timed) / len(timed), peak


def device_time_by_group(prof, ours):
    """(rows, groups, busy ms) of a ``torch.profiler`` trace: every device
    kernel and memory operation as (name, ms, count), and their sums by
    group: each of our kernels (``ours``, matched by name), cuDNN
    convolutions, GroupNorm, library GEMMs, memory operations, the rest."""
    from torch.autograd import DeviceType
    # kernels and memory operations only: a host annotation (Optimizer.step#...)
    # also shows on the device timeline, over the kernels it spans
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and '#' not in e.key]
    groups = {}
    for key, ms, count in rows:
        group = next((k for k in ours if k in key), None)
        if group is None:
            low = key.lower()
            group = ('memset / memcpy' if low.startswith('mem') else
                     'convolutions (cuDNN)' if any(w in low for w in (
                         'cudnn', 'conv', 'fprop', 'wgrad', 'dgrad', 'winograd', 'nchw', 'nhwc',
                         'fft', 'cf32', 'pointwise_mult_and_sum'))
                     else 'GroupNorm' if any(w in low for w in (
                         'groupnorm', 'group_norm', 'rowwisemoments', 'computefusedparams',
                         'computeinternalgradients', 'gammabeta'))
                     else 'GEMMs (cuBLAS: Linear layers)' if any(w in low for w in (
                         'gemm', 'cublas', 'cutlass'))
                     else 'other PyTorch kernels')
        total, n = groups.get(group, (0., 0))
        groups[group] = (total + ms, n + count)
    return rows, groups, sum(ms for _, ms, _ in rows)


def print_device_time(rows, groups, busy_ms, window_ms, units, unit):
    print(f'{units} {unit}s: {window_ms / units:.3f} ms a {unit} by CUDA events (profiler on), '
          f'device busy {busy_ms / units:.3f} ms a {unit} = {100 * busy_ms / window_ms:.1f}% of '
          'the window')
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f'  {ms / units:8.3f} ms a {unit}  {100 * ms / busy_ms:5.1f}%  {count // units:5d} '
              f'launches a {unit}  {group}')
    print('  the 8 longest kernels:')
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f'  {ms / units:8.3f} ms a {unit}  {count // units:5d} x  {key[:90]}')


def profile_device_time(run, units, unit, ours, json_name):
    """Where the device time of ``units`` calls of ``run`` goes, under
    ``torch.profiler``: summed by group, printed, and written to
    ``results/chip_smoke/<json_name>``. Reported, not required: a profiler
    that sees no device time only says so. Returns the groups as
    {name: (ms, launches)} over all units, or None."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(units):
            run()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows, groups, busy_ms = device_time_by_group(prof, ours)
    if busy_ms == 0:
        print('the profiler recorded no device time')
        return None
    print_device_time(rows, groups, busy_ms, window_ms, units, unit)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, json_name), 'w') as f:
        json.dump({unit + 's': units, 'window_ms': window_ms, 'device_busy_ms': busy_ms,
                   'groups': {k: {'ms': v[0], 'launches': v[1]} for k, v in groups.items()},
                   'kernels': [{'name': k, 'ms': ms, 'launches': n} for k, ms, n in rows]}, f)
    return groups


def profile_training_steps(model, batch, steps=3):
    """Three SwinIR training steps on a fixed batch, device time by kernel."""
    phase(f'6b. device time of {steps} training steps by kernel (torch.profiler)')
    model.lq, model.gt = batch
    for _ in range(2):
        model.optimize_parameters(0)
    # K2's two launches by their kernels' names; the last: K3's and K5's LayerNorm launch
    ours = ('swin_attn_fwd_head', 'swin_attn_fwd_proj', 'swin_attn_block_bwd', 'mlp_block_fwd',
            'mlp_block_bwd', 'swin_block_joint_fwd', 'branch_ln_bwd')
    profile_device_time(lambda: model.optimize_parameters(0), steps, 'step', ours,
                        'train_step_profile.json')


def compare_gradients(what, loss_k, grads_k, loss_p, grads_p):
    """Hold one batch's loss and parameter gradients through the kernels
    against those through the plain versions: each gradient within
    GRAD_TOLERANCE of the plain one's largest entry."""
    floor = 1e-6 * max(g.abs().max().item() for g in grads_p.values())
    worst, worst_name = 0., ''
    for name, g in grads_p.items():
        if not torch.isfinite(grads_k[name]).all():
            fail(f'non-finite gradient of {name}')
        rel = (grads_k[name] - g).abs().max().item() / max(g.abs().max().item(), floor)
        if rel > worst:
            worst, worst_name = rel, name
    print(f'loss {loss_k:.7f} (kernels) vs {loss_p:.7f} (plain); {len(grads_p)} parameter '
          f'gradients, largest max|difference| / max|plain|: {worst:.3e} at {worst_name} '
          f'(tolerance {GRAD_TOLERANCE})')
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or worst > GRAD_TOLERANCE:
        fail(f'{what}: loss or gradients disagree between kernels and plain versions')


def check_model_gradients():
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.utils.options import yaml_load
    phase('7. whole model, forward and backward: kernels vs plain versions, one training batch')
    net_opt = dict(yaml_load(TRAIN_CONFIG)['network_g'])
    net_opt.pop('type')
    net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0)).cuda().train()
    gen = torch.Generator().manual_seed(2)
    lq = torch.rand(4, 3, 48, 48, generator=gen).cuda()
    gt = torch.rand(4, 3, 192, 192, generator=gen).cuda()

    def loss_and_grads():
        net.seed_drop_path(123, 'cuda')   # the same DropPath masks in both runs
        net.zero_grad(set_to_none=True)
        loss = (net(lq) - gt).abs().mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    plain = [(S, 'swin_attn_block_forward', S.reference_swin_attn_block),
             (S, 'swin_attn_block_backward', S.reference_swin_attn_block_backward),
             (M, 'mlp_block_forward', M.reference_mlp_block),
             (M, 'mlp_block_backward', M.reference_mlp_block_backward)]
    counts = {k: w.launches for k, w in training_kernels().items()}
    patches = [mock.patch.object(mod, name, fn) for mod, name, fn in plain]
    for p in patches:
        p.start()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    if counts != {k: w.launches for k, w in training_kernels().items()}:
        fail('the plain run launched a kernel')
    compare_gradients('SwinIR', loss_k, grads_k, loss_p, grads_p)


# ------------------------------------------------------------------ ResShift
RS_CONFIG = 'options/test/ResShift/test_ResShift_x4_synthetic.yml'
RS_TRAIN_CONFIG = 'options/train/ResShift/train_ResShift_x4_synthetic.yml'
RS_DATA_DIR = 'datasets/ResShift_x4_synthetic'
RS_REQUESTS, RS_LQ, RS_TRAIN_IMAGES = 4, 64, 32
RS_LAYERS = 9   # Swin layers of the UNet: four down, the middle one, four up
RS_AMP_ITERS = 2
# kernels vs plain versions through 15 reverse steps, on the latent and on the
# [-1, 1] image: float32 sums in another order through 270 attention calls
RS_SAMPLE_TOLERANCE = 1e-3


def attention_wrappers():
    from basicsr4rs_torch.ops import window_attention as A
    return {'window_attention_fwd': A.window_attention_forward,
            'window_attention_bwd': A.window_attention_backward}


def resshift_options(config):
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(config)
    steps = opt['diffusion']['steps']
    per_forward = RS_LAYERS * opt['network_g']['swin_depth']
    return opt, steps, per_forward


def random_resshift_weights(opt, seed=0):
    """(UNet, first stage) with random weights made from ``seed`` and every
    parameter non-zero: the zero-initialised convolutions, which make a fresh
    UNet answer 0 to everything, get the other convolutions' init, and the
    codebook is spread over the latents' range ([-1, 1]) instead of the
    init's +-1/8192, so that the decoded image depends on the latent."""
    from basicsr4rs_torch.archs.arch_util import default_conv_init_
    from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
    from basicsr4rs_torch.archs.unet_arch import UNetModelSwin
    gen = torch.Generator().manual_seed(seed)
    net = UNetModelSwin(**{k: v for k, v in opt['network_g'].items() if k != 'type'},
                        generator=gen)
    with torch.no_grad():
        for m in net.modules():
            if getattr(m, 'zero_init', False):
                default_conv_init_(m, gen)
    stage = VQModelTorch(**{k: v for k, v in opt['autoencoder'].items() if k != 'type'},
                         generator=gen)
    with torch.no_grad():
        stage.quantize.embedding.weight.uniform_(-1., 1., generator=gen)
    return net, stage


def write_resshift_inputs(opt):
    """Synthetic pairs (GT 256x256, LQ 64x64: 4 to serve, 32 to train on,
    one to validate) and the seed-0 random weights the test config names."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(2)
    size = SCALE * RS_LQ
    for gt_dir, lq_dir, count in (('test_GT', 'test_LQ', RS_REQUESTS),
                                  ('GT', 'LQ', RS_TRAIN_IMAGES), ('val_GT', 'val_LQ', 1)):
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(RS_DATA_DIR, sub), exist_ok=True)
        for i in range(count):
            gt = smooth_image(rng, size, size)
            lq = cv2.resize(gt, (RS_LQ, RS_LQ), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(RS_DATA_DIR, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(RS_DATA_DIR, lq_dir, f'{i:04d}.png'), lq)
    net, stage = random_resshift_weights(opt)
    for module, key in ((net, 'pretrain_network_g'), (stage, 'pretrain_network_ae')):
        os.makedirs(os.path.dirname(opt['path'][key]), exist_ok=True)
        torch.save({'params': module.state_dict()}, opt['path'][key])


def serve_resshift():
    import cv2
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import window_attention as A
    phase('8. serve ResShift x4 through basicsr4rs_torch.test on cuda:0 (LQ 64x64, batch 1, '
          '15 reverse steps on a 64x64x3 latent, VQ-f4 decode to 256x256)')
    opt, steps, per_forward = resshift_options(RS_CONFIG)
    write_resshift_inputs(opt)
    per_request = per_forward * steps
    wrappers = attention_wrappers()
    for w in wrappers.values():
        w.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', RS_CONFIG]
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrappers['window_attention_fwd'].launches
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, {RS_REQUESTS} requests, '
          f'metrics, image writes); window_attention_fwd launches {launches} = '
          f'{launches / RS_REQUESTS:g} per request ({per_forward} per UNet forward x {steps} steps)')
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != per_request * RS_REQUESTS or wrappers['window_attention_bwd'].launches:
        fail(f'expected {per_request} forward launches per request and no backward launch, '
             f'counted {launches} and {wrappers["window_attention_bwd"].launches}')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{name} is not finite')
    out_dir = os.path.join(model.opt['path']['visualization'], 'RGB', 'ResShift_x4_synthetic')
    size = SCALE * RS_LQ
    for i in range(RS_REQUESTS):
        img = cv2.imread(os.path.join(out_dir, f'{i:04d}', 'result.png'))
        if img is None or img.shape != (size, size, 3):
            fail(f'saved image {i}: {None if img is None else img.shape}')
    csv_path = os.path.join(model.opt['path']['visualization'],
                            f'ResShift_x4_synthetic_{model.opt["name"]}.csv')
    with open(csv_path) as f:
        rows = f.read().splitlines()
    if len(rows) != RS_REQUESTS + 1:
        fail(f'{csv_path} has {len(rows)} lines')

    # per-request latency of the model's own test(), after a warm-up request
    dataset_opt = model.opt['datasets']['test_1']
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    loader = list(build_dataloader(build_dataset(dataset_opt), dataset_opt))
    model.feed_data(loader[0])
    model.test()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    for item in loader:
        model.feed_data(item)
        before = wrappers['window_attention_fwd'].launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.test()
        end.record()
        torch.cuda.synchronize()
        out = model.output
        if out.shape != (1, 3, size, size) or not torch.isfinite(out).all():
            fail(f'request: output {tuple(out.shape)}')
        if wrappers['window_attention_fwd'].launches - before != per_request:
            fail(f'a request did not launch the forward kernel {per_request} times')
        latencies.append(start.elapsed_time(end))
        print(f'request LQ {RS_LQ}x{RS_LQ} -> {size}x{size}: {latencies[-1]:.3f} ms '
              f'({latencies[-1] / steps:.3f} ms a reverse step, decode included)')
    print(f'request latency: mean {sum(latencies) / len(latencies):.3f} ms of {len(latencies)}; '
          f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')

    # one request through the kernels and through the plain versions, same seed
    kept = {}
    decode = model.base_diffusion.decode_first_stage

    def keep_latent(z, *args, **kwargs):
        kept['z'] = z.clone()
        return decode(z, *args, **kwargs)

    results = []
    with mock.patch.object(model.base_diffusion, 'decode_first_stage', keep_latent):
        for plain in (False, True):
            model.generator.manual_seed(11)
            model.feed_data(loader[1])
            if plain:
                with mock.patch.object(swinir_arch, 'fused_window_attention',
                                       A.reference_window_attention):
                    model.test()
            else:
                model.test()
            with torch.inference_mode():
                codes = model.first_stage.quantize(kept['z'])[2]
            results.append((kept['z'], model.output.clone(), codes))
    if wrappers['window_attention_fwd'].launches != per_request * (2 * RS_REQUESTS + 2):
        fail('the plain request launched a kernel')
    (z_k, img_k, codes_k), (z_p, img_p, codes_p) = results
    z_err = (z_k - z_p).abs().max().item()
    img_err = (img_k - img_p).abs().max().item()
    flipped = int((codes_k != codes_p).sum())
    print(f'kernels vs plain versions, one request, same seed: latent max abs difference '
          f'{z_err:.3e}, image {img_err:.3e} on [-1, 1] (tolerance {RS_SAMPLE_TOLERANCE}); '
          f'{flipped} of {codes_k.numel()} code indices differ')
    # a latent at the border of two codes' cells may fall either way: then,
    # and only then, the image may differ there
    if z_err > RS_SAMPLE_TOLERANCE or flipped > 4 or (flipped == 0 and
                                                      img_err > RS_SAMPLE_TOLERANCE):
        fail('the sampled request differs between kernels and plain versions')

    phase('8b. device time of 2 sampled requests by kernel (torch.profiler)')

    def request():
        model.feed_data(loader[0])
        model.test()

    profile_device_time(request, 2, 'request', tuple(wrappers), 'resshift_request_profile.json')
    print('of which the first stage alone (bicubic x4, VQ-f4 encode of the LQ, quantize and '
          'decode of a latent):')
    lq = model.lq

    def first_stage_only():
        with torch.inference_mode():
            z = model.base_diffusion.encode_first_stage(lq, model.first_stage, up_sample=True)
            model.base_diffusion.decode_first_stage(z, model.first_stage)

    profile_device_time(first_stage_only, 2, 'request', tuple(wrappers),
                        'resshift_first_stage_profile.json')
    return launches


def train_resshift():
    import glob
    import shutil

    from basicsr4rs_torch.models.resshift_model import ResShiftModel
    from basicsr4rs_torch.ops import window_attention as A
    opt, steps, per_forward = resshift_options(RS_TRAIN_CONFIG)
    batch = opt['datasets']['train']['batch_size_per_gpu']
    phase(f'9. train ResShift x4 through basicsr4rs_torch.train on cuda:0 (batch {batch}, '
          'GT 256 -> latent 64x64, float32)')
    total_iter = opt['train']['total_iter']
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):   # a clean start: no archived copies, no resume
        shutil.rmtree(old)
    wrappers = attention_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}

    def keep_first_batch(model, record):
        record.setdefault('batch', (model.lq.clone(), model.gt.clone()))

    common = dict(config=RS_TRAIN_CONFIG, model_cls=ResShiftModel, loss_key='loss',
                  wrappers=wrappers, before_first_step=keep_first_batch)
    t0 = time.perf_counter()
    model = run_train_pipeline([], record, **common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    run = record['steps']
    validations = total_iter // opt['val']['val_freq'] + 1
    print(f'pipeline wall time {wall:.3f} s for {len(run)} steps, {validations} validations '
          f'(one image, {steps} reverse steps each), checkpoints')
    for st in run:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, loss {st["loss"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()))
    if [st['iter'] for st in run] != list(range(1, total_iter + 1)):
        fail(f'expected steps 1..{total_iter}, ran {[st["iter"] for st in run]}')
    for st in run:
        if not torch.isfinite(torch.tensor(st['loss'])):
            fail(f'the loss is not finite at step {st["iter"]}')
        if set(st['launches'].values()) != {per_forward}:
            fail(f'step {st["iter"]}: launches {st["launches"]}, expected {per_forward} of each')
    if model.skipped_steps:
        fail(f'{model.skipped_steps} steps were skipped as non-finite')
    want = {'window_attention_fwd': per_forward * (total_iter + steps * validations),
            'window_attention_bwd': per_forward * total_iter}
    if launches != want:
        fail(f'launches in the run {launches}, expected {want}')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items()))
    timed = [st['ms'] for st in run[2:]]
    step_ms = sum(timed) / len(timed)
    print(f'training step: {step_ms:.3f} ms mean of steps 3..{total_iter} (min {min(timed):.3f}, '
          f'max {max(timed):.3f}; CUDA events around optimize_parameters, after 2 warm-up '
          f'steps); peak device memory {peak:.1f} MiB at batch {batch}')

    check_ema_and_checkpoint(model, random_resshift_weights(opt, seed=1)[0],
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))

    resumed = {'steps': []}
    run_train_pipeline(['--auto_resume', '--force_yml',
                        f'train:total_iter={total_iter + RESUME_ITERS}'], resumed, **common)
    iters = [st['iter'] for st in resumed['steps']]
    print(f'resumed from {total_iter}.state: ran steps {iters}, loss '
          + ' '.join(f'{st["loss"]:.6f}' for st in resumed['steps']))
    if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
        fail(f'resume should continue at step {total_iter + 1}, ran {iters}')

    phase('9b. device time of 2 training steps by kernel (torch.profiler)')
    model.feed_data(dict(zip(('lq', 'gt'), record['batch'])))
    model.optimize_parameters(0)
    profile_device_time(lambda: model.optimize_parameters(0), 2, 'step', tuple(wrappers),
                        'resshift_train_step_profile.json')
    del model

    phase(f'9c. {RS_AMP_ITERS} training steps under use_amp: true (bfloat16 autocast)')
    dtypes = {name: [] for name in wrappers}
    spies = []
    for name, attr in (('window_attention_fwd', '_launch_forward'),
                       ('window_attention_bwd', '_launch_backward')):
        def spy(qkv, *args, _inner=getattr(A, attr), _name=name):
            dtypes[_name].append(qkv.dtype)   # the dtype each launch is made in
            return _inner(qkv, *args)
        spies.append(mock.patch.object(A, attr, spy))
    amp = {'steps': []}
    for sp in spies:
        sp.start()
    try:
        run_train_pipeline(['--force_yml', 'train:use_amp=true', f'train:total_iter={RS_AMP_ITERS}',
                            f'name={opt["name"]}_amp', 'val:val_freq=100',
                            'logger:save_checkpoint_freq=100'], amp, **common)
    finally:
        for sp in spies:
            sp.stop()
    for st in amp['steps']:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, loss {st["loss"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()))
        if not torch.isfinite(torch.tensor(st['loss'])):
            fail(f'the loss under use_amp is not finite at step {st["iter"]}')
    # the steps, then the validation after the loop in forward launches
    bf16 = {k: sum(d == torch.bfloat16 for d in v) for k, v in dtypes.items()}
    print(f'bfloat16 launches: {bf16}')
    if (bf16['window_attention_bwd'] != per_forward * RS_AMP_ITERS
            or bf16['window_attention_fwd'] < per_forward * RS_AMP_ITERS
            or any(d != torch.bfloat16 for v in dtypes.values() for d in v)):
        fail(f'under use_amp the attention kernels should run in bfloat16: {bf16}')
    return launches


def check_resshift_gradients():
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import window_attention as A
    from basicsr4rs_torch.utils.gaussian_diffusion import create_gaussian_diffusion
    opt, steps, per_forward = resshift_options(RS_TRAIN_CONFIG)
    batch = opt['datasets']['train']['batch_size_per_gpu']
    phase('10. ResShift, forward and backward: kernels vs plain versions, one training batch '
          f'of {batch}')
    net, stage = random_resshift_weights(opt)
    net, stage = net.cuda().train(), stage.cuda().eval().requires_grad_(False)
    diffusion = create_gaussian_diffusion(**opt['diffusion'])
    gen = torch.Generator().manual_seed(4)
    size = SCALE * RS_LQ
    lq = (torch.rand(batch, 3, RS_LQ, RS_LQ, generator=gen) * 2 - 1).cuda()
    gt = (torch.rand(batch, 3, size, size, generator=gen) * 2 - 1).cuda()
    tt = torch.randint(0, steps, (batch,), generator=gen).cuda()
    noise = torch.randn(batch, 3, RS_LQ, RS_LQ, generator=gen).cuda()

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        losses, _, _ = diffusion.training_losses(None, lambda x, t: net(x, t, lq=lq), gt, lq, tt,
                                                 first_stage_model=stage, noise=noise)
        loss = losses['mse'].mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    wrappers = attention_wrappers()
    counts = {k: w.launches for k, w in wrappers.items()}
    loss_k, grads_k = loss_and_grads()
    if {k: w.launches - counts[k] for k, w in wrappers.items()} != dict.fromkeys(wrappers,
                                                                                per_forward):
        fail('the kernel run did not launch each attention kernel once per Swin block')
    counts = {k: w.launches for k, w in wrappers.items()}
    with mock.patch.object(swinir_arch, 'fused_window_attention', A.reference_window_attention):
        loss_p, grads_p = loss_and_grads()
    if counts != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    compare_gradients('ResShift', loss_k, grads_k, loss_p, grads_p)


def check_l2s_unet():
    """Phase 10b: UNetModelSwin at ``L2S_CONFIG``'s ``network_g`` (window 9,
    as read from the YAML), seed-0 weights, forward and backward at B=2 of
    its 72x72 latents through the kernels and through the plain versions."""
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.archs.arch_util import default_conv_init_
    from basicsr4rs_torch.archs.unet_arch import BasicLayer, UNetModelSwin
    from basicsr4rs_torch.ops import window_attention as A
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(L2S_CONFIG)
    net_opt = {k: v for k, v in opt['network_g'].items() if k != 'type'}
    size, ws, batch = net_opt['image_size'], net_opt['window_size'], 2
    phase(f'10b. UNetModelSwin of {os.path.basename(L2S_CONFIG)} (window {ws}, model channels '
          f'{net_opt["model_channels"]}, Swin {net_opt["swin_embed_dim"]}), forward and backward '
          f'at B={batch} of {size}x{size} latents: kernels vs plain versions')
    gen = torch.Generator().manual_seed(0)
    net = UNetModelSwin(**net_opt, generator=gen)
    with torch.no_grad():   # no zero-initialised convolution: every parameter shows
        for m in net.modules():
            if getattr(m, 'zero_init', False):
                default_conv_init_(m, gen)
    net = net.cuda().train()
    per_forward = sum(len(m.blocks) for m in net.modules() if isinstance(m, BasicLayer))
    channels = net_opt['in_channels']
    x = torch.randn(batch, channels, size, size, generator=gen).cuda()
    lq = torch.randn(batch, channels, net_opt['lq_size'], net_opt['lq_size'], generator=gen).cuda()
    target = torch.randn(batch, net_opt['out_channels'], size, size, generator=gen).cuda()
    tt = torch.randint(0, opt['diffusion']['steps'], (batch,), generator=gen).cuda()

    def run():
        net.zero_grad(set_to_none=True)
        out = net(x, tt, lq=lq)
        loss = (out - target).pow(2).mean()
        loss.backward()
        return out.detach().clone(), loss.item(), {k: q.grad.clone()
                                                   for k, q in net.named_parameters()}

    wrappers = attention_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out_k, loss_k, grads_k = run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f'launches {launches}: {per_forward} Swin blocks a forward')
    if launches != dict.fromkeys(wrappers, per_forward):
        fail(f'expected {per_forward} launches of each attention kernel, counted {launches}')
    with mock.patch.object(swinir_arch, 'fused_window_attention', A.reference_window_attention):
        out_p, loss_p, grads_p = run()
    if launches != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    err = (out_k - out_p).abs().max().item()
    print(f'output: max abs difference {err:.3e} (max|plain| {out_p.abs().max().item():.3e}; '
          f'tolerance {MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('UNetModelSwin at window 9: the outputs disagree')
    compare_gradients('UNetModelSwin at window 9', loss_k, grads_k, loss_p, grads_p)
    del net, grads_k, grads_p
    return launches


# ------------------------------------------------------------ the video path
def sampler_wrappers():
    from basicsr4rs_torch.ops import dcn as D
    return {'deform_sample_fwd': D.deform_sample_forward,
            'deform_sample_bwd': D.deform_sample_backward}


SAMPLER_DEVICE_KERNELS = ('deform_sample_fwd', 'deform_sample_dx', 'deform_sample_doffset')


def plain_sampler():
    """Patches that put the sampler's plain versions in place of both kernels."""
    from basicsr4rs_torch.ops import dcn as D
    return [mock.patch.object(D, 'deform_sample_forward', D.reference_deform_sample),
            mock.patch.object(D, 'deform_sample_backward', D.reference_deform_sample_backward)]


def moving_clip(rng, frames, h, w):
    """``frames`` uint8 frames (h, w, 3): one smooth random image seen through
    a window that moves two pixels right and one down a frame."""
    big = smooth_image(rng, h + frames + 16, w + 2 * frames + 16)
    return [big[i:i + h, 2 * i:2 * i + w] for i in range(frames)]


def write_clips(root, name, clips, lq_size):
    """GT and LQ frames (LQ the bicubic x4 downscale) of ``clips`` {clip:
    frames} under ``<root>/<name>_GT`` / ``_LQ``, and ``meta_info_<name>.txt``."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(sum(map(ord, root + name)))
    h, w = lq_size
    for clip, frames in clips.items():
        for sub in ('GT', 'LQ'):
            os.makedirs(os.path.join(root, f'{name}_{sub}', clip), exist_ok=True)
        for i, gt in enumerate(moving_clip(rng, frames, SCALE * h, SCALE * w)):
            lq = cv2.resize(gt, (w, h), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, f'{name}_GT', clip, f'{i:08d}.png'), gt)
            cv2.imwrite(os.path.join(root, f'{name}_LQ', clip, f'{i:08d}.png'), lq)
    with open(os.path.join(root, f'meta_info_{name}.txt'), 'w') as f:
        f.writelines(f'{clip} {frames} ({SCALE * h},{SCALE * w},3)\n'
                     for clip, frames in clips.items())


def seed0_video_weights(opt, path):
    """Seed-0 random weights of the config's network. The last offset
    convolutions, which start at zero, get small random weights: otherwise
    every deformable sample would sit on a pixel."""
    from basicsr4rs_torch.archs import build_network
    torch.manual_seed(0)
    net = build_network(opt['network_g'])
    with torch.no_grad():
        for name, p in net.named_parameters():
            if 'conv_offset' in name and not p.any():
                p.normal_(0., 0.02 if p.dim() > 1 else 0.5)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'params': net.state_dict()}, path)


def edvr_launches(frames_in_item):
    """Sampler launches of one EDVR forward: PCD levels 3, 2, 1 and the
    cascade, the frames folded into the batch."""
    return 4


def basicvsrpp_launches(t):
    """Sampler launches of one BasicVSR++ forward on t frames: 4 (t - 1)
    alignments with nine taps; with one tap SpyNet's 6 levels (both
    directions in one batch), a feature warp a step and branch, and a flow and
    a feature warp from a branch's third step on."""
    return 4 * (t - 1) + 6 + 4 * (t - 1) + 8 * (t - 2)


VIDEO = {
    'EDVR-M': dict(
        test_config='options/test/EDVR/test_EDVR_M_x4_synthetic.yml',
        train_config='options/train/EDVR/train_EDVR_M_x4_synthetic.yml',
        data='datasets/EDVR_M_x4_synthetic',
        # 2 clips of 5 frames (reflection_circle needs as many as the window):
        # 10 requests, each a window of 5 frames
        clips={'test': ({'300': 5, '301': 5}, VIDEO_LQ),
               'train': ({'100': 8, '101': 8}, (80, 80)), 'val': ({'200': 5}, (64, 64))},
        forward_launches=edvr_launches, backward_skipped=0, train_frames=EDVR_FRAMES,
        boundary_key='tsa_iter', frozen='conv_first.weight', free='fusion.feat_fusion.weight'),
    'BasicVSR++': dict(
        test_config='options/test/BasicVSRPP/test_BasicVSRPP_x4_synthetic.yml',
        train_config='options/train/BasicVSRPP/train_BasicVSRPP_x4_synthetic.yml',
        data='datasets/BasicVSRPP_x4_synthetic',
        # one clip of 30 frames: one request
        clips={'test': ({'300': 30}, VIDEO_LQ),
               'train': ({'100': 32, '101': 32}, (72, 72)), 'val': ({'200': 4}, (64, 64))},
        # SpyNet's first warp has a zero flow and an input image: no backward
        forward_launches=basicvsrpp_launches, backward_skipped=1, train_frames=30,
        boundary_key='fix_flow', frozen='spynet.basic_module.5.basic_module.0.weight',
        free='conv_last.weight'),
}


def serve_video(name, number):
    """Serve one video model through ``basicsr4rs_torch.test``; then time
    requests, repeat one on the plain versions, and profile one."""
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.utils.options import yaml_load
    spec = VIDEO[name]
    opt = yaml_load(spec['test_config'])
    phase(f'{number}. serve {name} x4 through basicsr4rs_torch.test on cuda:0 '
          f'(LQ {VIDEO_LQ[0]}x{VIDEO_LQ[1]})')
    clips, lq_size = spec['clips']['test']
    write_clips(spec['data'], 'test', clips, lq_size)
    seed0_video_weights(opt, opt['path']['pretrain_network_g'])
    wrappers = sampler_wrappers()
    for w in wrappers.values():
        w.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', spec['test_config']]
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrappers['deform_sample_fwd'].launches
    loader = [item for item in model_loader(model)]
    expected = sum(spec['forward_launches'](item['lq'].shape[1]) for item in loader)
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, {len(loader)} requests, '
          f'metrics, image writes); sampler launches {launches}, '
          f'{launches / len(loader):g} a request')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != expected or wrappers['deform_sample_bwd'].launches != 0:
        fail(f'expected {expected} forward launches of the sampler and no backward, counted '
             f'{launches} and {wrappers["deform_sample_bwd"].launches}')
    for folder, rows in model.metric_results_per_folder.items():
        print(f'clip {folder}: PSNR {rows[:, 0].mean():.4f} dB over {len(rows)} frames '
              '(random weights)')
        if not np.isfinite(rows).all():
            fail(f'a metric of clip {folder} is not finite')
    frames = sum(clips.values())
    saved = sum(len(files) for _, _, files in os.walk(
        os.path.join(model.opt['path']['visualization'], opt['datasets']['test_1']['name'])))
    if saved != frames:
        fail(f'{saved} images saved, expected {frames}')

    # latency of the model's own test(), after a warm-up request
    model.feed_data(loader[0])
    model.test()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    for item in loader[:4]:
        model.feed_data(item)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.test()
        end.record()
        torch.cuda.synchronize()
        out = model.output
        t = item['lq'].shape[1]
        want = (1, t, 3) if out.dim() == 5 else (1, 3)
        want += (SCALE * lq_size[0], SCALE * lq_size[1])
        if tuple(out.shape) != want or not torch.isfinite(out).all():
            fail(f'request: output {tuple(out.shape)}, expected {want}')
        latencies.append(start.elapsed_time(end))
        frames_out = t if out.dim() == 5 else 1
        print(f'request of {t} LQ frames {lq_size[0]}x{lq_size[1]} -> {frames_out} frames '
              f'{want[-2]}x{want[-1]}: {latencies[-1]:.3f} ms, '
              f'{latencies[-1] / frames_out:.3f} ms an output frame')
    print(f'request latency: mean {sum(latencies) / len(latencies):.3f} ms of {len(latencies)}; '
          f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    if name == 'BasicVSR++':   # F4: where the request's memory goes
        net = getattr(model.net_g, 'module', model.net_g)
        stages = [('feat_extract', net.feat_extract, 'forward'),
                  ('compute_flow (SpyNet)', net, 'compute_flow'),
                  (lambda feats, flows, module: f'propagate {module}', net, 'propagate'),
                  ('upsample', net, 'upsample')]
        stages += [(f'  {name}', getattr(net, name), 'forward') for name in (
            'reconstruction', 'upconv1', 'upconv2', 'pixel_shuffle', 'conv_hr', 'lrelu',
            'conv_last')]
        model.feed_data(loader[0])
        torch.cuda.empty_cache()
        with MemoryMarks(stages) as marks:
            model.test()
        marks.show(f'{name} request of {loader[0]["lq"].shape[1]} frames')

    # one request through the kernels and through the plain versions
    before = wrappers['deform_sample_fwd'].launches
    model.feed_data(loader[-1])
    model.test()
    with_kernels = model.output.float().clamp(0, 1)
    per_request = wrappers['deform_sample_fwd'].launches - before
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        model.test()
    finally:
        for p in patches:
            p.stop()
    if wrappers['deform_sample_fwd'].launches != before + per_request:
        fail('the plain request launched a kernel')
    err = (with_kernels - model.output.float().clamp(0, 1)).abs().max().item()
    print(f'kernels vs plain versions, one request: max abs difference on the [0, 1] output '
          f'{err:.3e} (tolerance {MODEL_TOLERANCE})')
    if err > MODEL_TOLERANCE:
        fail(f'{name}: the request differs between kernels and plain versions')

    phase(f'{number}b. device time of a {name} request by kernel (torch.profiler)')
    profile_device_time(model.test, 2, 'request', SAMPLER_DEVICE_KERNELS,
                        f'{name.lower().replace("+", "p")}_request_profile.json')
    del model
    torch.cuda.empty_cache()
    return launches, sum(latencies) / len(latencies)


def train_video(name, number):
    """Train one video model through ``basicsr4rs_torch.train`` for the
    config's 8 iterations; then resume for two more and profile a step."""
    import glob
    import shutil

    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.registry import MODEL_REGISTRY
    spec = VIDEO[name]
    opt = yaml_load(spec['train_config'])
    total_iter, boundary = opt['train']['total_iter'], opt['train'][spec['boundary_key']]
    train_opt = opt['datasets']['train']
    batch, lq = train_opt['batch_size_per_gpu'], train_opt['gt_size'] // SCALE
    phase(f'{number}. train {name} x4 through basicsr4rs_torch.train on cuda:0 (batch {batch} of '
          f'{spec["train_frames"]} LQ frames {lq}x{lq}; {spec["boundary_key"]}: {boundary})')
    for part in ('train', 'val'):
        write_clips(spec['data'], part, *spec['clips'][part])
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):
        shutil.rmtree(old)
    model_cls = MODEL_REGISTRY.get(opt['model_type'])
    wrappers = sampler_wrappers()
    for w in wrappers.values():
        w.launches = 0
    forward = spec['forward_launches'](spec['train_frames'])
    backward = forward - spec['backward_skipped']

    def watch(model, record):
        """Before step 1: keep the first batch and two parameters to follow."""
        params = dict(model.net_g.named_parameters())
        record['watched'] = {k: params[spec[k]] for k in ('frozen', 'free')}
        record['previous'] = {k: p.detach().clone() for k, p in record['watched'].items()}
        record['fixed'] = (model.lq.clone(), model.gt.clone())
        record['fixed_loss_before'] = fixed_batch_loss(model, record['fixed'])

    def moved(model, step):
        for k, p in record['watched'].items():
            step[k + '_moved'] = not torch.equal(p, record['previous'][k])
            record['previous'][k] = p.detach().clone()

    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline([], record, config=spec['train_config'], model_cls=model_cls,
                               wrappers=wrappers, before_first_step=watch, after_step=moved)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    steps = record['steps']
    print(f'pipeline wall time {wall:.3f} s for {len(steps)} steps, validations, checkpoints')
    for st in steps:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items())
              + f'; {spec["frozen"]} moved: {st["frozen_moved"]}, {spec["free"]} moved: '
              f'{st["free_moved"]}')
    if [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'expected steps 1..{total_iter}, ran {[st["iter"] for st in steps]}')
    for st in steps:
        if not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'l_pix is not finite at step {st["iter"]}')
        if st['launches'] != {'deform_sample_fwd': forward, 'deform_sample_bwd': backward}:
            fail(f'step {st["iter"]}: launches {st["launches"]}, expected {forward} forward '
                 f'and {backward} backward')
        # the warm-up discards the frozen parameters' updates before its boundary
        if st['frozen_moved'] != (st['iter'] >= boundary) or not st['free_moved']:
            fail(f'step {st["iter"]}: the warm-up boundary is at {boundary}, '
                 f'{spec["frozen"]} moved: {st["frozen_moved"]}')
    timed = [st['ms'] for st in steps[2:]]
    mean_ms = sum(timed) / len(timed)
    print(f'training step: {mean_ms:.3f} ms mean of steps 3..{total_iter} (min {min(timed):.3f}, '
          f'max {max(timed):.3f}; CUDA events around optimize_parameters, after 2 warm-up '
          f'steps); peak device memory {peak:.1f} MiB')
    print('launches in the run (steps, validations, the fixed batch): '
          + ' '.join(f'{k}={v}' for k, v in launches.items()))
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step '
          f'1, {loss_after:.6f} after step {total_iter} (Adam, lr '
          f'{opt["train"]["optim_g"]["lr"]}, the config\'s)')
    if not loss_after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')

    # EMA, checkpoint, resume
    check_ema_and_checkpoint(model, build_network(opt['network_g']),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))
    resumed = {'steps': []}
    run_train_pipeline(['--auto_resume', '--force_yml',
                        f'train:total_iter={total_iter + RESUME_ITERS}'], resumed,
                       config=spec['train_config'], model_cls=model_cls, wrappers=wrappers,
                       before_first_step=lambda model, record: None)
    iters = [st['iter'] for st in resumed['steps']]
    print(f'resumed from {total_iter}.state: ran steps {iters}, l_pix '
          + ' '.join(f'{st["l_pix"]:.6f}' for st in resumed['steps']))
    if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
        fail(f'resume should continue at step {total_iter + 1}, ran {iters}')

    phase(f'{number}b. device time of 2 {name} training steps by kernel (torch.profiler)')
    model.lq, model.gt = record['fixed']
    model.optimize_parameters(total_iter)
    profile_device_time(lambda: model.optimize_parameters(total_iter), 2, 'step',
                        SAMPLER_DEVICE_KERNELS,
                        f'{name.lower().replace("+", "p")}_step_profile.json')
    del model
    torch.cuda.empty_cache()
    return launches, mean_ms, peak


def check_video_gradients(name, number):
    """One training batch forward and backward through the sampler's kernels
    and through its plain versions: the loss and every parameter's gradient."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    spec = VIDEO[name]
    opt = yaml_load(spec['train_config'])
    phase(f'{number}. {name}, forward and backward: kernels vs plain versions, one training batch')
    path = os.path.join('experiments', 'chip_smoke_gradients.pth')
    seed0_video_weights(opt, path)
    net = build_network(opt['network_g'])
    net.load_state_dict(torch.load(path, map_location='cpu', weights_only=True)['params'])
    net = net.cuda().train()
    train_opt = opt['datasets']['train']
    batch, lq = train_opt['batch_size_per_gpu'], train_opt['gt_size'] // SCALE
    rng = __import__('numpy').random.RandomState(5)
    clips = [moving_clip(rng, spec['train_frames'], lq, lq) for _ in range(batch)]
    x = torch.from_numpy(__import__('numpy').stack(
        [[f.transpose(2, 0, 1) for f in clip] for clip in clips])).float().div(255).cuda()
    with torch.no_grad():
        shape = net(x).shape
    gt = torch.rand(shape, generator=torch.Generator().manual_seed(6)).cuda()

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        loss = torch.sqrt((net(x) - gt)**2 + 1e-12).mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    wrappers = sampler_wrappers()
    counts = {k: w.launches for k, w in wrappers.items()}
    loss_k, grads_k = loss_and_grads()
    if any(w.launches == counts[k] for k, w in wrappers.items()):
        fail('the kernel run launched no kernel')
    counts = {k: w.launches for k, w in wrappers.items()}
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    if counts != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    compare_gradients(name, loss_k, grads_k, loss_p, grads_p)


# ------------------------------------------- the serving modes of the image-SR path
PEAK_OPS_INT8 = 1979e12   # dense int8 on the tensor cores (the data sheet's rate)
CONV_SHAPES = [            # (B, Cin, Cout, H, W, residual, slope): how SwinIR-M x4 calls K10
    (1, 180, 180, 128, 128, True, None),    # RSTB tail and conv_after_body, LQ 128x128
    (16, 180, 180, 64, 64, True, None),     # the same at the batched serving shape
    (1, 180, 64, 128, 128, False, 0.01),    # conv_before_upsample
    (1, 64, 256, 128, 128, False, None),    # Upsample, LQ map
    (1, 64, 256, 256, 256, False, None),    # Upsample, 2x map
    (1, 64, 64, 512, 512, False, 0.2),      # nearest+conv: conv_hr on the 4x map
    (1, 180, 180, 125, 94, True, None),     # a map that is no multiple of 8
]
# K11 against its plain version. The integer sums are exact in both, but the
# values that are quantised come from float32 arithmetic in another order
# (LayerNorm, softmax, the dequantised products), so a value that sits on a
# half can round to the next integer in one and not in the other, and
# everything downstream in that window then differs by far more than
# F32_TOL. So the kernel also writes out the integers and scales it fed to
# its four products, and the plain version is run a second time downstream
# of them (each product takes the kernel's integers in place of its own).
# The rule, with nothing fitted to a reading:
# - every integer of the kernel equals the plain version's rounding of what
#   it finds at that place, or differs from it by one step where the
#   unrounded value lies within INT8_HALF_EPS steps of a half (float32
#   rounding noise there is about 1e-5 steps); every scale agrees to
#   INT8_SCALE_TOL. In bfloat16 the attention output, which proj reads,
#   agrees between kernel and plain version to BF16_TOL of its largest value
#   only (they round q, k, v, p and the output to bfloat16 at different
#   places), and the largest value is 127 steps: proj's scales may differ by
#   BF16_TOL and its integers by 127 BF16_TOL steps and one for the rounding.
# - the output is within F32_TOL (BF16_TOL) of that second plain run, in
#   every element;
# - against the plain version on its own (whose integers then differ from
#   the kernel's at those flips, at a few more that an ulp of a scale brings,
#   and downstream of both), only windows that hold a differing integer may
#   leave F32_TOL, and a window's error stays under INT8_FLIP_REACH times
#   the sum over its differing integers of s_x * max|w|, which is what one
#   step moves the product it enters by (127 steps of s_x * s_w); the factor
#   is for the softmax, the GELU and the later products on the way.
INT8_HALF_EPS = 1e-3
INT8_SCALE_TOL = 1e-5
INT8_FLIP_REACH = 4.
# int8 block against the float block: the JAX package's criterion
# (tests/test_ops/test_swin_block.py): SNR and the largest deviation over the range
INT8_BLOCK_SNR_DB, INT8_BLOCK_MAX_DEV = 30., 0.1
# bfloat16 K11's output against the float32 float block on the same inputs
# (full-scale weights, block_inputs): a bound set 3 dB under the lowest
# reading of this script on an NVIDIA H100 80GB HBM3 (38.14 to 38.25 dB at
# B=1 128x128 and B=16 64x64, shift 0 and 4; the values come from a seed)
INT8_BLOCK_SNR_BF16_DB = 35.1
# The models' int8 outputs against their float outputs. Under the
# configs' own initialisation (linears of std 0.02, MSRResNet's convolutions
# scaled by 0.1) the quantised layers' branches lie far under the residual
# stream and the skip, and an int8 route a hundred times too noisy would
# still read 80 dB at the output. So both phases redraw the weights of the
# layers that are quantised at std 1/sqrt(fan_in), as phase 3f does
# (MSRResNet's residual blocks keep their factor of 0.1, on the second
# convolution: at full scale the noise of 35 quantised convolutions in a row
# adds up to 22.7 dB, under the JAX package's bound), and hold an SNR to a
# bound set 3 dB under the lowest reading of this script on an NVIDIA H100
# 80GB HBM3 (the values come from a seed: the readings repeat). SwinIR-M:
# the output, read at 53.85 and 53.91 dB. MSRResNet: the branch, which is the
# output less its bilinear skip, read at 33.29 to 33.69 dB; the output itself
# (60.7 dB, most of it the skip) keeps the JAX package's bound
# (tests/test_ops/test_quant.py:148).
INT8_MODEL_SNR_DB = 50.8
INT8_CONV_BRANCH_SNR_DB = 30.2
INT8_CONV_SNR_DB = 28.
# tiling a window-attention model is approximate (each tile sees its halo, not
# the image): the bound of tests/test_torch_tile.py on the [0, 1] output
TILE_APPROX_TOLERANCE = 0.05
MS_CONFIG = 'options/test/SRResNet_SRGAN/test_MSRResNet_x4_synthetic.yml'
MS_TRAIN_CONFIG = 'options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml'
MS_DATA_DIR = 'datasets/MSRResNet_x4_synthetic'
MS_LQ_SIZES = [(128, 128), (96, 160)]
TILED_DIR = 'datasets/SwinIR_M_x4_tiled'
TILED_LQ, TILE, TILE_PAD = 512, 128, 32
JOINT_TRAIN_ITERS = 4


def snr_db(ref, got):
    ref, got = ref.double(), got.double()
    return (10 * torch.log10(ref.square().mean() / ((got - ref).square().mean() + 1e-30))).item()


def psnr_db(ref, got):
    """PSNR of two [0, 1] images."""
    mse = (ref.double().clamp(0, 1) - got.double().clamp(0, 1)).square().mean().item()
    return 10 * torch.log10(torch.tensor(1. / max(mse, 1e-30))).item()


# the layouts phase 3e hands K10 at the RSTB's shape, beside the NCHW ones of
# CONV_SHAPES: channels-last memory, and the RSTB's own view of its tokens
CONV_LAYOUTS = ('channels_last', 'token view')


def conv_operand(t, layout):
    """``t`` (B, C, H, W) in one of the layouts K10 takes."""
    if layout == 'nchw':
        return t
    if layout == 'channels_last':
        return t.contiguous(memory_format=torch.channels_last)
    b, c, h, w = t.shape   # tokens (B, HW, C), seen as the RSTB sees them
    return t.flatten(2).transpose(1, 2).contiguous().transpose(1, 2).reshape(b, c, h, w)


def check_conv_kernel():
    import torch.nn.functional as F

    from basicsr4rs_torch.ops import conv3x3 as K
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3, reference_conv3x3
    phase('3e. 3x3 convolution kernel (K10) vs plain version, at the shapes SwinIR-M x4 gives it')
    lib = K._lib()
    print('K10 (mma.sync: 3xTF32 for float32, bfloat16): shared memory a block ' + ', '.join(
        f'{lib.conv3x3_fwd_smem_bytes(n)} bytes at {n} output channels' for n in K.BLOCK_N)
        + '; registers and spills in phase 2')
    gen = torch.Generator().manual_seed(5)
    summary = {'max_abs_err': 0.}
    cases = [(shape, 'nchw') for shape in CONV_SHAPES] + [
        (CONV_SHAPES[0], layout) for layout in CONV_LAYOUTS]
    for (b, cin, cout, h, w, model_res, model_slope), layout in cases:
        for dt in (torch.float32, torch.bfloat16):
            x = conv_operand(torch.randn(b, cin, h, w, generator=gen).cuda().to(dt), layout)
            weight = (torch.randn(cout, cin, 3, 3, generator=gen) * (9 * cin)**-.5).cuda()
            bias = (torch.randn(cout, generator=gen) * .1).cuda()
            res = conv_operand(torch.randn(b, cout, h, w, generator=gen).cuda().to(dt), layout)
            worst = 0.
            for with_res, slope in ((False, None), (True, None), (False, 0.2), (True, 0.01)):
                r = res if with_res else None
                with torch.no_grad():
                    got = fused_conv3x3(x, weight, bias, r, slope)
                    want = reference_conv3x3(x, weight, bias, r, slope)
                torch.cuda.synchronize()
                ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
                worst = max(worst, max_abs)
                if not ok or not got.is_contiguous(memory_format=torch.channels_last):
                    fail(f'K10 and plain version disagree at {(b, cin, cout, h, w)} {layout} {dt} '
                         f'residual={with_res} slope={slope}: max_abs_err={max_abs:.3e} '
                         f'({tolerance}), or the output is not channels-last')
            r = res if model_res else None
            wd, bd = weight.to(dt), bias.to(dt)

            def library():    # one cuDNN convolution and PyTorch's own epilogue
                out = F.conv2d(x, wd, bd, padding=1)
                if r is not None:
                    out = out + r
                return out if model_slope is None else F.leaky_relu(out, model_slope)

            def kernel():
                return fused_conv3x3(x, weight, bias, r, model_slope)

            with torch.no_grad():
                kernel_ms, library_ms = time_pair(library, kernel)
                plain_ms = cuda_time_ms(lambda: reference_conv3x3(x, weight, bias, r, model_slope))
                device_ms = kernel_device_ms(kernel, iters=5)
                k10_ms = kernel_device_ms(kernel, iters=5, only='conv3x3_fwd_kernel')
                library_device_ms = kernel_device_ms(library, iters=5)
                call_us = host_us(kernel, iters=50)
            es = torch.finfo(dt).bits // 8
            flop = 2 * 9 * cin * cout * b * h * w
            nbytes = (b * h * w * (cin + cout * (2 if model_res else 1)) + 9 * cin * cout) * es \
                + 4 * cout
            (bound, by), core_bound = tensor_core_bound_ms(flop, nbytes, dt)
            print(f'B={b} {cin}->{cout} {h}x{w} {layout:13s} {str(dt)[6:]:8s} residual={model_res} '
                  f'slope={model_slope}: four epilogues max_abs_err={worst:.3e} | kernel '
                  f'{kernel_ms:.4f} ms, F.conv2d + epilogue {library_ms:.4f} ms (ratio '
                  f'{kernel_ms / library_ms:.2f}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms '
                  f'by {by} on the route ({100 * bound / kernel_ms:.0f}%), CUDA-core bound '
                  f'{core_bound:.4f} ms | device: the call {show_ms(device_ms)} of which K10 '
                  f'{show_ms(k10_ms)}, the library {show_ms(library_device_ms)}; host '
                  f'{call_us:.1f} us a call', flush=True)
            if dt == torch.float32:
                summary['max_abs_err'] = max(summary['max_abs_err'], worst)
            times = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                         bound_by=by, device_ms=device_ms, kernel_device_ms=k10_ms,
                         library_device_ms=library_device_ms)
            if (b, cin, cout, h) == (1, 180, 180, 128):   # the RSTB tail at LQ 128x128
                if dt == torch.float32 and layout == 'token view':   # as the main path calls it
                    summary.update(times)
                else:
                    summary[f'{layout} {str(dt)[6:]}'] = times
            del x, res, got, want
    # gradients: the backward is PyTorch's library on the kernel's saved output,
    # with x and the residual channels-last as the RSTB hands them over
    for layout in ('nchw', 'token view'):
        x = conv_operand(torch.randn(2, 64, 48, 48, generator=gen).cuda(), layout).requires_grad_()
        weight = (torch.randn(64, 64, 3, 3, generator=gen) / 24).cuda().requires_grad_()
        bias = torch.randn(64, generator=gen).cuda().requires_grad_()
        res = conv_operand(torch.randn(2, 64, 48, 48, generator=gen).cuda(), layout)
        res.requires_grad_()
        leaves = (x, weight, bias, res)
        got = torch.autograd.grad(fused_conv3x3(*leaves, 0.2).square().sum(), leaves)
        want = torch.autograd.grad(reference_conv3x3(*leaves, 0.2).square().sum(), leaves)
        for name, g, wnt in zip(('dx', 'd_weight', 'd_bias', 'd_residual'), got, want):
            ok, max_abs, max_rel, tolerance = compare(g, wnt, torch.float32, 'sum')
            print(f'gradient {name} ({layout}): max_abs_err={max_abs:.3e} '
                  f'max_rel_err={max_rel:.3e} ({tolerance})')
            if not ok:
                fail(f'K10 gradient {name} disagrees ({layout})')
    return {'conv3x3_fwd': summary}


def int8_block_work(b, h, w, dtype, shifted, widths=M_WIDTHS):
    """(int8 operations, model-dtype operations, bytes) of one W8A8 block:
    the four weight products in int8, q.k and p.v in the model dtype; x in, out back,
    int8 weights, scales and the small float operands once."""
    c, heads, ws, hid = widths
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    small = 4 * (8 * c + hid) + 4 * heads * n * n + 4 * (5 * c + hid)
    mask = 4 * (h // ws) * (w // ws) * n * n if shifted else 0
    return (t * (8 * c * c + 4 * c * hid), t * 4 * n * c,
            2 * t * c * es + 4 * c * c + 2 * c * hid + small + mask)


def check_int8_flips(got, rec, plain_rec, forced, want, want_rec, dt, weights, tag):
    """Holds one K11 output to the rule above. ``rec``: the kernel's (q, s)
    of the four products; ``plain_rec``: the plain version's (q, s, r)
    downstream of them; ``forced``: its output there; ``want``, ``want_rec``:
    its output and its (q, s, r) on its own; ``weights``: the largest |w| of
    each product's float weight. Returns the line to print and the largest
    error against ``want``."""
    f32 = dt == torch.float32
    b, hw, ww = rec[0][1].shape
    reach = torch.zeros(b, hw, ww, device='cuda')   # sum over differing integers of s_x max|w|
    counts = []
    for name, (q, s), (qp, sp, r), (qw, _, _), wmax in zip(
            ('qkv', 'proj', 'fc1', 'fc2'), rec, plain_rec, want_rec, weights):
        exact = f32 or name != 'proj'
        scale_err = ((s - sp).abs() / sp).max().item()
        if not scale_err <= (INT8_SCALE_TOL if exact else BF16_TOL):
            fail(f'K11 {tag}: the scales of {name} differ by {scale_err:.2e} of the plain ones')
        d = q.int() - qp.int()
        flip = d != 0
        from_half = ((r - r.floor()) - .5).abs()
        most = 1 if exact else int(127 * BF16_TOL) + 1
        if int(d.abs().max()) > most or (
                exact and bool((flip & (from_half > INT8_HALF_EPS)).any())):
            far = from_half[flip].max().item() if flip.any() else 0.
            fail(f'K11 {tag}: an integer of {name} differs from the plain rounding by '
                 f'{int(d.abs().max())} steps, or by one where the value lies {far:.2e} steps '
                 f'from a half (allowed {INT8_HALF_EPS})')
        steps = (q.int() - qw.int()).abs().reshape(b, hw, WS, ww, WS, -1).sum(dim=(2, 4, 5))
        reach += steps * s * wmax
        counts.append(f'{name} {int(flip.sum())}' + ('' if exact else f' (by <= {most} steps)')
                      + (f' (<= {from_half[flip].max().item():.1e} from a half)'
                         if exact and flip.any() else ''))
    ok, max_abs, max_rel, tolerance = compare(got, forced, dt, 'elementwise')
    line = (f'{tag}: integers that differ from the plain rounding: {", ".join(counts)}; '
            f'downstream of the kernel\'s integers max_abs_err={max_abs:.3e} '
            f'max_rel_err={max_rel:.3e} ({tolerance})')
    if not ok:
        print(line)
        fail(f'K11 {tag}: the output disagrees with the plain version on the same integers')
    if f32:
        err = (got - want).abs()
        off = err > F32_TOL[0] + F32_TOL[1] * want.abs()
        windows = off.reshape(b, hw, WS, ww, WS, -1).any(5).any(4).any(2)
        worst = err.reshape(b, hw, WS, ww, WS, -1).amax(dim=(2, 4, 5))
        ratio = (worst[windows] / reach[windows]).max().item() if windows.any() else 0.
        line += (f'; against the plain version on its own: {int(windows.sum())} of '
                 f'{windows.numel()} windows beyond F32_TOL, {int((reach > 0).sum())} hold a '
                 f'differing integer, max_abs_err={err.max().item():.3e}, at most {ratio:.2f} of '
                 f'a window\'s differing steps x s_x max|w| (allowed {INT8_FLIP_REACH:g})')
        if bool((windows & (reach == 0)).any()) or ratio > INT8_FLIP_REACH:
            print(line)
            fail(f'K11 {tag}: a window without a differing integer leaves F32_TOL, or one '
                 'errs by more than its differing integers explain')
    return line, (got - want).abs().max().item()


def check_int8_block_kernel():
    from basicsr4rs_torch.ops import swin_block as S
    phase('3f. W8A8 joint block kernel (K11) vs plain version and vs the float block')
    print(f'rule: the kernel\'s integers equal the plain rounding, or differ by one step within '
          f'{INT8_HALF_EPS} steps of a half; scales within {INT8_SCALE_TOL}; the output within '
          f'F32_TOL {F32_TOL} (bfloat16: {BF16_TOL} of max|plain|) of the plain version run on '
          f'those integers; against the plain version on its own only windows with a differing '
          f'integer differ, by at most {INT8_FLIP_REACH:g} x their steps\' s_x max|w|; against '
          f'the float block SNR > {INT8_BLOCK_SNR_DB} dB and max deviation < '
          f'{INT8_BLOCK_MAX_DEV} of the range')
    gen = torch.Generator().manual_seed(6)
    summary = {'max_abs_err': 0.}
    both = (torch.float32, torch.bfloat16)
    cases = [(b, h, w, dt, shift, M_WIDTHS) for b, h, w in ((1, 128, 128), (16, 64, 64))
             for dt in both for shift in (0, 4)]
    # past the float joint kernel's widths: the wide variant (phase 22's widths)
    cases += [(2, 64, 64, dt, shift, widths) for widths in WIDE_WIDTHS for dt in both
              for shift in (0, 4)]
    for b, h, w, dt, shift, widths in cases:
        args = block_inputs(b, h, w, dt, shift, gen, *widths)
        weights = [args[i].abs().max().item() for i in (3, 5, 11, 13)]
        rec, plain_rec, want_rec = [], [], []
        with torch.no_grad():
            got = S.swin_block_full_int8(*args, quantised=rec)
            forced = S.reference_swin_block_full_int8(*args, given=rec,
                                                      quantised=plain_rec)
            want = S.reference_swin_block_full_int8(*args, quantised=want_rec)
            flo = S.reference_swin_block_full(*args)
            plainly = S.swin_block_full_int8(*args)
        torch.cuda.synchronize()
        tag = f'B={b} {h}x{w} {str(dt)[6:]:8s} shift={shift}' + (
            '' if widths == M_WIDTHS else f' C={widths[0]} heads={widths[1]}')
        if not torch.isfinite(got).all():
            fail(f'K11 output is not finite at {tag}')
        if not torch.equal(got, plainly):
            fail(f'K11 {tag}: writing out the integers changed the output')
        line, max_abs = check_int8_flips(got.float(), rec, plain_rec, forced.float(),
                                         want.float(), want_rec, dt, weights, tag)
        del rec, plain_rec, want_rec, forced
        if dt == torch.float32:
            summary['max_abs_err'] = max(summary['max_abs_err'], max_abs)
        else:
            ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
            line += (f'; against the plain version on its own max_rel_err={max_rel:.3e} '
                     f'({tolerance})')
            if not ok:
                print(line)
                fail(f'K11 and plain version disagree at {tag}')
        snr = snr_db(flo.float(), got.float())
        dev = (got.float() - flo.float()).abs().max().item() / flo.float().abs().max().item()
        line += f' | vs float block: SNR {snr:.2f} dB, max deviation {dev:.4f} of the range'
        if snr <= INT8_BLOCK_SNR_DB or dev >= INT8_BLOCK_MAX_DEV:
            print(line)
            fail(f'K11 is too far from the float block at {tag}')
        if dt == torch.bfloat16:
            with torch.no_grad():
                flo32 = S.reference_swin_block_full(
                    *[a.float() if torch.is_tensor(a) else a for a in args])
            snr32 = snr_db(flo32, got.float())
            line += (f', vs the float32 float block SNR {snr32:.2f} dB (bound '
                     f'{INT8_BLOCK_SNR_BF16_DB})')
            del flo32
            if snr32 <= INT8_BLOCK_SNR_BF16_DB:
                print(line)
                fail(f'bfloat16 K11 is too far from the float32 block at {tag}')
        with torch.no_grad():
            kernel_ms, plain_ms = time_pair(
                lambda: S.reference_swin_block_full_int8(*args),
                lambda: S.swin_block_full_int8(*args))
            # K1 beside it where it takes the width
            k1_ms = (cuda_time_ms(lambda: S.swin_block_full_forward(*args))
                     if widths == M_WIDTHS else None)
        ops8, ops_attn, nbytes = int8_block_work(b, h, w, dt, shift, widths)
        (attn_ms, _), attn_core_ms = tensor_core_bound_ms(ops_attn, 0, dt)
        by_bytes = nbytes / PEAK_BYTES * 1e3
        by_ops = ops8 / PEAK_OPS_INT8 * 1e3 + attn_ms
        bound, by = max((by_ops, 'operations'), (by_bytes, 'bytes'))
        # on the CUDA cores: __dp4a (four int8 products an instruction) and float32
        core_bound = max((ops8 / (4 * PEAK_FLOPS_F32)) * 1e3 + attn_core_ms, by_bytes)
        line += (f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                 + ('' if k1_ms is None else f'float kernel (K1) {k1_ms:.4f} ms, ')
                 + f'bound {bound:.4f} ms by {by} (int8 products at '
                 f'{PEAK_OPS_INT8 / 1e12:.0f} TOP/s, q.k and p.v {ROUTE[dt]}; on the CUDA '
                 f'cores {core_bound:.4f} ms)')
        print(line, flush=True)
        if (b, dt, shift) == (1, torch.float32, 4):
            summary.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           k1_ms=k1_ms, cuda_core_bound_ms=core_bound)
    check_int8_half_rounding(gen)
    return {'swin_block_joint_int8_fwd': summary}


def check_int8_half_rounding(gen):
    """K11 rounds an activation that lands exactly on k + 0.5 to even, as
    ``torch.round`` and ``jnp.round`` do (``rintf``; ``roundf`` would round it
    away from zero). LayerNorms with weight 0 hand every token their bias:
    half-integers whose absmax is 127, so the window scale is exactly 1 and
    the inputs of qkv and fc1 are those halves. Every integer of the kernel
    at an exact half must equal the plain rounding there."""
    from basicsr4rs_torch.ops import swin_block as S
    for dt in (torch.float32, torch.bfloat16):
        args = block_inputs(1, 128, 128, dt, 0, gen)
        for i in (1, 9):   # ln1_weight, ln2_weight; ln1_bias, ln2_bias
            halves = torch.randint(-127, 127, (C,), generator=gen).float() + .5
            halves[int(torch.randint(C, (1,), generator=gen))] = 127.
            args[i], args[i + 1] = torch.zeros_like(args[i]), halves.cuda()
        rec, plain_rec = [], []
        with torch.no_grad():
            S.swin_block_full_int8(*args, quantised=rec)
            S.reference_swin_block_full_int8(*args, given=rec, quantised=plain_rec)
        torch.cuda.synchronize()
        counts = []
        for name, (q, _), (qp, _, r) in zip(('qkv', 'fc1'), rec[::2], plain_rec[::2]):
            on_half = (r - r.floor()) == .5
            wrong = int((on_half & (q.int() != qp.int())).sum())
            odd = int((on_half & (qp.int() % 2 != 0)).sum())
            counts.append(f'{name} {int(on_half.sum())} exact halves, {wrong} rounded otherwise')
            if not on_half.any() or wrong or odd:
                fail(f'K11 {str(dt)[6:]}: {counts[-1]} (the plain rounding gave {odd} odd '
                     'integers there): halves must round to even')
        print(f'K11 at exact halves, B=1 128x128 {str(dt)[6:]}: ' + '; '.join(counts)
              + ' (to even, as torch.round and jnp.round)', flush=True)



def once_ms(fn):
    """Milliseconds of one call after one warm-up call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed_test(model, item, repeats=3):
    """Mean milliseconds of ``model.test()`` on one loader item, CUDA events."""
    model.feed_data(item)
    model.test()
    return cuda_time_ms(model.test, repeats)


def serve_fused_conv():
    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    phase('17. serve SwinIR-M x4 through basicsr4rs_torch.test with SWIN_FUSED_CONV=1')
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', CONFIG]
    fused_conv3x3.launches = fused_swin_block_full.launches = 0
    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
        os.environ.pop('SWIN_FUSED_CONV')
    torch.cuda.synchronize()
    launches, k1 = fused_conv3x3.launches, fused_swin_block_full.launches
    per_forward = 6 + 1 + 1 + 2   # RSTB tails, conv_after_body, conv_before_upsample, Upsample
    print(f'K10 launches {launches} = {launches / len(LQ_SIZES):g} per request; K1 launches {k1}')
    if launches != per_forward * len(LQ_SIZES):
        fail(f'expected {per_forward} K10 launches per forward, counted {launches} over '
             f'{len(LQ_SIZES)} requests')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
    loader = list(model_loader(model))
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        model.test()
        cudnn = model.output.float().clamp(0, 1)
        times = []
        for fused in (False, True, True, False):
            if fused:
                os.environ['SWIN_FUSED_CONV'] = '1'
            try:
                times.append(timed_test(model, item))
            finally:
                os.environ.pop('SWIN_FUSED_CONV', None)
            if fused:
                out = model.output.float().clamp(0, 1)
        err = (out - cudnn).abs().max().item()
        fused_ms, cudnn_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        print(f'request LQ {h}x{w}: fused-conv route {fused_ms:.3f} ms, cuDNN route '
              f'{cudnn_ms:.3f} ms; max abs difference on [0, 1] {err:.3e} '
              f'(tolerance {MODEL_TOLERANCE})')
        if out.shape != (1, 3, SCALE * h, SCALE * w) or not err <= MODEL_TOLERANCE:
            fail(f'request {h}x{w}: the fused-conv route disagrees with the cuDNN route')
    return model, loader, launches, k1


def serve_int8(model, loader):
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.ops.quant import quantized_inference
    phase('18. SwinIR-M x4 under quantized_inference(net, min_channels=10**9, swin_kernels=True)')
    net = model.net_g
    blocks = sum(model.opt['network_g']['depths'])
    S.swin_block_full_int8.launches = 0
    forwards = 0
    gen = torch.Generator().manual_seed(7)
    batch = torch.rand(16, 3, 64, 64, generator=gen).cuda()
    linears = [p for name, p in net.named_parameters() if p.dim() == 2 and name.endswith(
        ('qkv.weight', 'proj.weight', 'fc1.weight', 'fc2.weight'))]
    if len(linears) != 4 * blocks:
        fail(f'found {len(linears)} linear weights in the blocks, expected {4 * blocks}')
    with torch.no_grad():   # at full scale, so that their error shows: see INT8_MODEL_SNR_DB
        for p in linears:
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1]**-.5)

    def scope():
        return quantized_inference(net, min_channels=10**9, swin_kernels=True)

    def forward(x):
        with torch.inference_mode():
            return net(x)

    for tag, x in (('B=16 LQ 64x64', batch), ('B=1 LQ 128x128', loader[0]['lq'].cuda())):
        flo = forward(x)
        with scope():
            got = forward(x)
            forwards += 1
            with mock.patch.object(swinir_arch, 'swin_block_full_int8',
                                   S.reference_swin_block_full_int8):
                plain = forward(x)
        torch.cuda.synchronize()
        if got.shape != flo.shape or not torch.isfinite(got).all():
            fail(f'{tag}: int8 output {tuple(got.shape)}')
        snr, routes = snr_db(flo, got), snr_db(plain, got)
        times = []
        for quantised in (False, True, True, False):
            if quantised:
                with scope():
                    forward(x)
                    times.append(cuda_time_ms(lambda: forward(x), 3))
                forwards += 1 + 3 + 3
            else:
                times.append(cuda_time_ms(lambda: forward(x), 3))
        int8_ms, float_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        mp = x.shape[0] * SCALE * x.shape[2] * SCALE * x.shape[3] / 1e3
        print(f'{tag}: int8 route {int8_ms:.3f} ms = {mp / int8_ms:.3f} output MP/s, float route '
              f'{float_ms:.3f} ms = {mp / float_ms:.3f} output MP/s; SNR of int8 against float '
              f'{snr:.2f} dB (bound {INT8_MODEL_SNR_DB}), PSNR on [0, 1] '
              f'{psnr_db(flo, got):.2f} dB; kernel route against plain route {routes:.2f} dB SNR')
        if snr < INT8_MODEL_SNR_DB:
            fail(f'{tag}: the int8 output is {snr:.2f} dB from the float output')
        # flips of single steps through 36 blocks: no more noise than the scheme's own
        if routes < snr:
            fail(f'{tag}: K11 route and plain route agree to {routes:.2f} dB only: further '
                 'apart than int8 is from float')
    launches = S.swin_block_full_int8.launches
    print(f'K11 launches {launches} over {forwards} forwards = {launches / forwards:g} per forward')
    if launches != blocks * forwards:
        fail(f'expected {blocks} K11 launches per forward')
    if swinir_arch.swin_kernels_int8():
        fail('the scope left swin_kernels_int8() on')
    return launches


def write_msrresnet_inputs():
    """Two synthetic pairs to serve, 16 GT 160x160 pairs to train on, one to
    validate, and the seed-0 weights the test config names."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(3)
    train_dir = MS_DATA_DIR + '_train'
    sets = [(MS_DATA_DIR, 'GT', 'LQ', [(SCALE * h, SCALE * w) for h, w in MS_LQ_SIZES]),
            (train_dir, 'GT', 'LQ', [(160, 160)] * 16), (train_dir, 'val_GT', 'val_LQ', [(256, 256)])]
    for root, gt_dir, lq_dir, sizes in sets:
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, (h, w) in enumerate(sizes):
            gt = smooth_image(rng, h, w)
            lq = cv2.resize(gt, (w // SCALE, h // SCALE), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(root, lq_dir, f'{i:04d}.png'), lq)
    opt = yaml_load(MS_CONFIG)
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    torch.manual_seed(0)
    net = MSRResNet(**net_opt)
    with torch.no_grad():    # biases off their zero init, so that every parameter shows;
        for name, p in net.named_parameters():   # weights at full scale, see INT8_MODEL_SNR_DB
            if name.endswith('bias'):
                p.normal_(0, 0.02)
            else:   # a residual block's branch keeps its init's factor of 0.1
                p.normal_(0, p[0].numel()**-.5 * (.1 if name.endswith('conv2.weight') else 1.))
    os.makedirs(os.path.dirname(opt['path']['pretrain_network_g']), exist_ok=True)
    torch.save({'params': net.state_dict()}, opt['path']['pretrain_network_g'])
    return net_opt


def serve_and_train_msrresnet():
    import glob
    import shutil

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.archs.arch_util import resize_bilinear
    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.models.sr_model import SRModel
    from basicsr4rs_torch.utils.options import yaml_load
    phase('19. MSRResNet x4 through basicsr4rs_torch.test in float, quant_int8: true and '
          'static; then 8 training steps through basicsr4rs_torch.train')
    net_opt = write_msrresnet_inputs()
    outputs, latency = {}, {}
    for mode, force in (('float', []), ('true', ['--force_yml', 'val:quant_int8=true']),
                        ('static', ['--force_yml', 'val:quant_int8=static'])):
        argv = sys.argv
        sys.argv = ['basicsr4rs_torch.test', '-opt', MS_CONFIG] + force
        try:
            model = entry.test_pipeline(ROOT)
        finally:
            sys.argv = argv
        if model.device.type != 'cuda':
            fail(f'MSRResNet ran on {model.device}')
        wanted = {'float': False, 'true': True, 'static': 'static'}[mode]
        if model.opt['val'].get('quant_int8', False) != wanted:
            fail(f'val.quant_int8 is {model.opt["val"].get("quant_int8")!r} in the {mode} run')
        if mode == 'static' and not model._quant_scales:
            fail('the static run calibrated no scale')
        loader = list(model_loader(model))
        outputs[mode] = []
        for item, (h, w) in zip(loader, MS_LQ_SIZES):
            model.feed_data(item)
            model.test()
            out = model.output.float()
            if out.shape != (1, 3, SCALE * h, SCALE * w) or not torch.isfinite(out).all():
                fail(f'MSRResNet {mode} request {h}x{w}: output {tuple(out.shape)}')
            outputs[mode].append(out)
        latency[mode] = timed_test(model, loader[0])
        print(f'{mode}: PSNR {model.metric_results["psnr"]:.4f} dB against the synthetic GT '
              f'(random weights); request LQ 128x128 {latency[mode]:.3f} ms')
        if any('forward' in m.__dict__ for m in model.net_g.modules()):
            fail('a convolution kept its int8 forward after the scope')
    # the output is the bilinear skip plus the network's branch
    skips = [resize_bilinear(item['lq'].cuda(), SCALE * h, SCALE * w)
             for item, (h, w) in zip(loader, MS_LQ_SIZES)]
    for mode in ('true', 'static'):
        for out, ref, skip, (h, w) in zip(outputs[mode], outputs['float'], skips, MS_LQ_SIZES):
            snr, branch = snr_db(ref, out), snr_db(ref - skip, out - skip)
            print(f'quant_int8 {mode}, LQ {h}x{w}: SNR against float {snr:.2f} dB '
                  f'(bound {INT8_CONV_SNR_DB}); of the branch alone (output minus the bilinear '
                  f'skip) {branch:.2f} dB (bound {INT8_CONV_BRANCH_SNR_DB})')
            if (snr <= INT8_CONV_SNR_DB or branch < INT8_CONV_BRANCH_SNR_DB
                    or torch.equal(out, ref)):
                fail(f'MSRResNet quant_int8 {mode}: SNR {snr:.2f} dB, of the branch '
                     f'{branch:.2f} dB, or the float output itself')

    opt = yaml_load(MS_TRAIN_CONFIG)
    total_iter = opt['train']['total_iter']
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):
        shutil.rmtree(old)
    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}
    model = run_train_pipeline([], record, config=MS_TRAIN_CONFIG, model_cls=SRModel)
    steps = record['steps']
    if model.device.type != 'cuda' or [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'MSRResNet training ran steps {[st["iter"] for st in steps]} on {model.device}')
    for st in steps:
        if not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'l_pix is not finite at step {st["iter"]}')
    timed = [st['ms'] for st in steps[2:]]
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'training step: {sum(timed) / len(timed):.3f} ms mean of steps 3..{total_iter} (min '
          f'{min(timed):.3f}, max {max(timed):.3f}); peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; l_pix '
          + ' '.join(f'{st["l_pix"]:.5f}' for st in steps))
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step 1, '
          f'{loss_after:.6f} after step {total_iter}')
    if not loss_after < record['fixed_loss_before']:
        fail('MSRResNet: the loss on the fixed batch did not fall')
    check_ema_and_checkpoint(model, MSRResNet(**net_opt),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))


class MemoryMarks:
    """Device memory of one run, stage by stage: each wrapped callable
    (``(label, owner, attribute)``: a module's forward, a method, a module's
    function; ``label`` may be a function of the call's arguments) marks its
    start and its return with the memory allocated then and the most
    allocated since the previous mark. Marks of nested stages split the
    outer stage's intervals."""

    def __init__(self, stages):
        self.stages, self.rows = stages, []

    def mark(self, what):
        self.rows.append((what, torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    def __enter__(self):
        self.kept = []
        for label, owner, attr in self.stages:
            own = attr in vars(owner)
            inner = getattr(owner, attr)

            def wrapped(*args, _inner=inner, _label=label, **kwargs):
                what = _label(*args) if callable(_label) else _label
                self.mark(f'{what} starts')
                out = _inner(*args, **kwargs)
                self.mark(f'{what} returns')
                return out

            self.kept.append((owner, attr, inner if own else None))
            setattr(owner, attr, wrapped)
        self.mark('the run starts')
        return self

    def __exit__(self, *exc):
        self.mark('the run ends')
        for owner, attr, inner in reversed(self.kept):
            if inner is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, inner)

    def show(self, title):
        """Prints the marks; returns the largest peak."""
        print(f'{title}: device memory at each mark (allocated then; most allocated since the '
              'previous mark), MiB')
        for what, live, peak in self.rows:
            print(f'  {live / 2**20:10.1f} {peak / 2**20:10.1f}  {what}')
        return max(peak for _, _, peak in self.rows)


def swinir_memory_stages(net):
    """The stages of a SwinIR forward for ``MemoryMarks``."""
    from basicsr4rs_torch.archs import swinir_arch
    stages = [('SwinIR forward', net, 'forward'), ('conv_first', net.conv_first, 'forward')]
    stages += [(f'RSTB {i}', layer, 'forward') for i, layer in enumerate(net.layers)]
    names = {id(m): n for n, m in net.named_modules()}
    stages += [(lambda conv, *_: f'3x3 conv {names.get(id(conv), "?")}', swinir_arch, 'conv3x3'),
               ('norm', net.norm, 'forward'), ('upsample', net.upsample, 'forward'),
               ('conv_last', net.conv_last, 'forward')]
    return stages


def serve_tiled():
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.inference import inference_swinir
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    from basicsr4rs_torch.ops.tile import tiled_apply
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'20. tiled serving: inference_swinir --tile {TILE} --tile_pad {TILE_PAD} on one LQ '
          f'{TILED_LQ}x{TILED_LQ} image; MSRResNet tiled with its receptive field as the pad')
    os.makedirs(os.path.join(TILED_DIR, 'LQ'), exist_ok=True)
    img = smooth_image(np.random.RandomState(4), TILED_LQ, TILED_LQ)
    cv2.imwrite(os.path.join(TILED_DIR, 'LQ', '0000.png'), img)
    out_dir = os.path.join('results', 'chip_smoke', 'tiled')
    fused_swin_block_full.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inference_swinir.main(['--model_path', WEIGHTS, '--task', 'classical_sr', '--input',
                           os.path.join(TILED_DIR, 'LQ'), '--output', out_dir, '--tile', str(TILE),
                           '--tile_pad', str(TILE_PAD)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_swin_block_full.launches
    tiles = (TILED_LQ // TILE)**2
    full = TILE + 2 * TILE_PAD
    print(f'inference_swinir: {wall:.3f} s wall (weights, read, {tiles} tiles of {full}x{full} as '
          f'one batch, write); K1 launches {launches}; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    saved = cv2.imread(os.path.join(out_dir, '0000_SwinIR.png'))
    if saved is None or saved.shape != (SCALE * TILED_LQ, SCALE * TILED_LQ, 3):
        fail(f'tiled output: {None if saved is None else saved.shape}')
    if launches != 36:
        fail(f'expected 36 K1 launches (one batched forward), counted {launches}')
    # against the untiled forward
    net = SwinIR(**inference_swinir.TASKS['classical_sr'])
    net.load_state_dict(inference_swinir.load_state_dict(WEIGHTS), strict=True)
    net.cuda().eval()
    x = torch.from_numpy(np.ascontiguousarray(
        img[..., ::-1].astype(np.float32).transpose(2, 0, 1) / 255.))[None].cuda()
    apply = inference_swinir.build_apply(net, SCALE, 8, TILE, TILE_PAD)
    tiled_ms = once_ms(lambda: apply(x))
    tiled = apply(x).clamp(0, 1)
    with torch.inference_mode():
        whole = net(x).clamp(0, 1)
        whole_ms = once_ms(lambda: net(x))
    written = torch.from_numpy(np.ascontiguousarray(saved[..., ::-1].transpose(2, 0, 1))).cuda()
    if ((tiled[0] * 255).round() - written.float()).abs().max().item() > 1:
        fail('the written image is not the tiled forward')
    err = (tiled - whole).abs()
    print(f'SwinIR-M x4 LQ {TILED_LQ}x{TILED_LQ}: tiled {tiled_ms:.1f} ms, untiled {whole_ms:.1f} '
          f'ms; tiled against untiled on [0, 1]: max {err.max().item():.3e}, mean '
          f'{err.mean().item():.3e} (a tile sees {TILE_PAD} pixels of halo, not the image: '
          f'tolerance {TILE_APPROX_TOLERANCE})')
    if not err.max().item() < TILE_APPROX_TOLERANCE:
        fail('tiled SwinIR is too far from the untiled forward')
    del tiled, whole
    # F4: where the memory of the tiled request goes, beside the untiled forward's
    peaks = {}
    for what, run, fused in (('tiled', lambda: apply(x), '0'),
                             ('untiled', lambda: inference_swinir.build_apply(net, SCALE, 8)(x),
                              '0'),
                             ('tiled, SWIN_FUSED_CONV=1', lambda: apply(x), '1')):
        torch.cuda.empty_cache()
        with mock.patch.dict(os.environ, {'SWIN_FUSED_CONV': fused}), \
                MemoryMarks(swinir_memory_stages(net)) as marks:
            run()
        peaks[what] = marks.show(f'SwinIR-M x4 LQ {TILED_LQ}x{TILED_LQ} {what}')
    print('peak device memory: ' + ', '.join(f'{what} {peak / 2**20:.1f} MiB'
                                             for what, peak in peaks.items()))
    del net
    # MSRResNet: 34 convolutions at LQ size, one at 2x, two at 4x: a receptive
    # field of 36 LQ pixels each way, covered by a pad of 40
    net_opt = dict(yaml_load(MS_CONFIG)['network_g'])
    net_opt.pop('type')
    net = MSRResNet(**net_opt)
    net.load_state_dict(torch.load(yaml_load(MS_CONFIG)['path']['pretrain_network_g'],
                                   weights_only=True)['params'])
    net.cuda().eval()

    def forward(v):
        with torch.inference_mode():
            return net(v)

    whole = forward(x)
    tiled = tiled_apply(forward, x, SCALE, TILE, 40)
    ok, max_abs, max_rel, tolerance = compare(tiled, whole, torch.float32, 'elementwise')
    print(f'MSRResNet x4 LQ {TILED_LQ}x{TILED_LQ}, tile {TILE}, pad 40: tiled against untiled '
          f'max_abs_err={max_abs:.3e} ({tolerance}); tiled '
          f'{once_ms(lambda: tiled_apply(forward, x, SCALE, TILE, 40)):.1f} ms, untiled '
          f'{once_ms(lambda: forward(x)):.1f} ms')
    if not ok:
        fail('tiled MSRResNet differs from the untiled forward')
    return launches


def train_joint(split_step_ms):
    import glob
    import shutil

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'21. train SwinIR-M x4 for {JOINT_TRAIN_ITERS} steps with SWIN_JOINT_TRAIN=1 (the '
          'joint kernel and its recomputing backward)')
    opt = yaml_load(TRAIN_CONFIG)
    blocks = sum(opt['network_g']['depths'])
    name = opt['name'] + '_joint'
    for old in glob.glob(os.path.join('experiments', name) + '*'):
        shutil.rmtree(old)
    wrappers = training_kernels()
    for w in wrappers.values():
        w.launches = 0
    record = {'steps': []}
    os.environ['SWIN_JOINT_TRAIN'] = '1'
    try:
        run_train_pipeline(['--force_yml', f'name={name}', f'train:total_iter={JOINT_TRAIN_ITERS}'],
                           record)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        # one training batch: the joint route's gradients against the split route's
        net_opt = dict(opt['network_g'])
        net_opt.pop('type')
        net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0)).cuda().train()
        gen = torch.Generator().manual_seed(2)
        lq = torch.rand(4, 3, 48, 48, generator=gen).cuda()
        gt = torch.rand(4, 3, 192, 192, generator=gen).cuda()

        def loss_and_grads():
            net.seed_drop_path(123, 'cuda')   # the same DropPath masks in both runs
            net.zero_grad(set_to_none=True)
            loss = (net(lq) - gt).abs().mean()
            loss.backward()
            return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

        loss_j, grads_j = loss_and_grads()
        os.environ['SWIN_JOINT_TRAIN'] = '0'
        loss_s, grads_s = loss_and_grads()
    finally:
        os.environ.pop('SWIN_JOINT_TRAIN')
    expected = {'swin_block_joint_fwd': blocks, 'swin_attn_block_fwd': blocks,
                'swin_attn_block_bwd': blocks, 'mlp_block_fwd': 0, 'mlp_block_bwd': blocks}
    for st in record['steps']:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()))
        if st['launches'] != expected or not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'step {st["iter"]}: launches {st["launches"]}, expected {expected}')
    if [st['iter'] for st in record['steps']] != list(range(1, JOINT_TRAIN_ITERS + 1)):
        fail(f'ran steps {[st["iter"] for st in record["steps"]]}')
    timed = [st['ms'] for st in record['steps'][2:]]
    print(f'training step on the joint route: {sum(timed) / len(timed):.3f} ms mean of steps '
          f'3..{JOINT_TRAIN_ITERS}'
          + ('' if split_step_ms is None else
             f'; on the split route (phase 6) {split_step_ms:.3f} ms'))
    compare_gradients('SwinIR joint route vs split route', loss_j, grads_j, loss_s, grads_s)
    return launches


WIDE_SWINIR = [(180, 3), (240, 8)]   # (embed, heads): heads of 60; SwinIR-L's 240 in 8 heads


def serve_wide_swinir():
    """Phase 22: SwinIR in eval at widths past the joint kernel's (C > 192 or
    heads wider than 32), depths [2, 2], LQ 64x64, seed-0 weights: each block
    through K2 + K4, no K1, against the plain forward; then, with the
    blocks' linears redrawn at full scale as in phase 18, under
    ``quantized_inference(net, min_channels=10**9, swin_kernels=True)``:
    each block through K11 (its wide variant) and nothing else, against the
    float forward by SNR (phase 18's bound) and against the plain int8
    route. Every width must run: a refusal (a block needing more shared
    memory than the card has, or past a gate) fails the phase. Returns the
    launches of K2, K4 and K11."""
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import _launch
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.ops.quant import quantized_inference
    phase('22. SwinIR past the joint kernel\'s widths (' + ', '.join(
        f'C={c} in {h} heads of {c // h}' for c, h in WIDE_SWINIR) + '), eval: K2 + K4 a block; '
        'under swin_kernels=True: K11 a block')
    gen = torch.Generator().manual_seed(0)
    lq = torch.rand(1, 3, 64, 64, generator=gen).cuda()
    counters = (S.fused_swin_block_full, S.swin_attn_block_forward, M.mlp_block_forward,
                S.swin_block_full_int8)
    launches = {'swin_attn_block_fwd': 0, 'mlp_block_fwd': 0, 'swin_block_joint_int8_fwd': 0}
    limit = _launch.shared_memory_limit(lq.device)
    for embed, heads in WIDE_SWINIR:
        depths = [2, 2]
        net = SwinIR(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.,
                     depths=depths, embed_dim=embed, num_heads=[heads] * len(depths),
                     mlp_ratio=2., upsampler='pixelshuffle', resi_connection='1conv',
                     generator=gen).cuda().eval()
        k2a, k2b = S.attn_forward_shared_memory(torch.float32, embed, heads)
        need = {'K2 (window, head) units': k2a, 'K2 proj tiles': k2b,
                'K4': M._lib('mlp_block_fwd').mlp_block_fwd_smem_bytes(0, embed),
                'K11': S._lib('swin_block_joint_int8_fwd').swin_block_joint_int8_fwd_smem_bytes(
                    0, embed, heads, 2 * embed)}
        tag = f'C={embed}, {heads} heads of {embed // heads}'
        if max(need.values()) > limit:
            fail(f'{tag}: a block needs {need} bytes of shared memory, the card has {limit}')
        for f in counters:
            f.launches = 0
        with torch.no_grad():
            out_k = net(lq)
        torch.cuda.synchronize()
        counts = [f.launches for f in counters]
        blocks = sum(depths)
        if counts != [0, blocks, blocks, 0]:
            fail(f'{tag}: launches K1, K2, K4, K11 {counts}, expected [0, {blocks}, {blocks}, 0]')
        launches['swin_attn_block_fwd'] += blocks
        launches['mlp_block_fwd'] += blocks
        plain = [mock.patch.object(S, 'swin_attn_block_forward', S.reference_swin_attn_block),
                 mock.patch.object(M, 'mlp_block_forward', M.reference_mlp_block)]
        for q in plain:
            q.start()
        try:
            with torch.no_grad():
                out_p = net(lq)
        finally:
            for q in plain:
                q.stop()
        if [f.launches for f in counters] != counts:
            fail(f'{tag}: the plain forward launched a kernel')
        err = (out_k - out_p).abs().max().item()
        print(f'{tag}: K1 0, K2 {blocks}, K4 {blocks} launches; shared memory a block {need} '
              f'bytes (the card {limit}); output max abs difference from the plain forward '
              f'{err:.3e} (max|plain| {out_p.abs().max().item():.3e}, tolerance {MODEL_TOLERANCE})')
        if not err <= MODEL_TOLERANCE:
            fail(f'{tag}: the output disagrees with the plain forward')
        linears = [p for name, p in net.named_parameters() if p.dim() == 2 and name.endswith(
            ('qkv.weight', 'proj.weight', 'fc1.weight', 'fc2.weight'))]
        with torch.no_grad():   # at full scale, so that their error shows: see INT8_MODEL_SNR_DB
            for p in linears:
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1]**-.5)
            flo = net(lq)
        for f in counters:
            f.launches = 0
        with quantized_inference(net, min_channels=10**9, swin_kernels=True), torch.no_grad():
            got = net(lq)
            counts = [f.launches for f in counters]
            with mock.patch.object(swinir_arch, 'swin_block_full_int8',
                                   S.reference_swin_block_full_int8):
                plain_route = net(lq)
        torch.cuda.synchronize()
        if counts != [0, 0, 0, blocks]:
            fail(f'{tag}, int8: launches K1, K2, K4, K11 {counts}, expected [0, 0, 0, {blocks}]')
        launches['swin_block_joint_int8_fwd'] += blocks
        if got.shape != flo.shape or not torch.isfinite(got).all():
            fail(f'{tag}, int8: output {tuple(got.shape)}')
        snr, routes = snr_db(flo, got), snr_db(plain_route, got)
        print(f'{tag}, under swin_kernels=True: K11 {blocks} launches, no other block kernel; '
              f'SNR of int8 against float {snr:.2f} dB (bound {INT8_MODEL_SNR_DB}), kernel route '
              f'against plain route {routes:.2f} dB SNR', flush=True)
        if snr < INT8_MODEL_SNR_DB:
            fail(f'{tag}: the int8 output is {snr:.2f} dB from the float output')
        if routes < snr:
            fail(f'{tag}: K11 route and plain route agree to {routes:.2f} dB only: further '
                 'apart than int8 is from float')
    return launches


SUMMARY_KEYS = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
KERNELS = [
    ('swin_block_joint_fwd', 'basicsr4rs_tpu/ops/swin_block.py:287'),
    ('swin_attn_block_fwd', 'basicsr4rs_tpu/ops/swin_block.py:244'),
    ('swin_attn_block_bwd', 'basicsr4rs_tpu/ops/swin_block.py:405'),
    ('mlp_block_fwd', 'basicsr4rs_tpu/ops/mlp_block.py:74'),
    ('mlp_block_bwd', 'basicsr4rs_tpu/ops/mlp_block.py:97'),
    ('window_attention_fwd', 'basicsr4rs_tpu/ops/window_attention.py:120'),
    ('window_attention_bwd', 'basicsr4rs_tpu/ops/window_attention.py:227'),
    ('deform_sample_fwd', 'basicsr4rs_tpu/ops/dcn.py:174'),
    ('deform_sample_bwd', 'basicsr4rs_tpu/ops/dcn.py:224'),
    ('conv3x3_fwd', 'basicsr4rs_tpu/ops/conv3x3.py:47'),
    ('swin_block_joint_int8_fwd', 'basicsr4rs_tpu/ops/swin_block.py:354'),
]


def serving_modes(launches, split_step_ms):
    """Phases 17 to 22: the serving modes of the image-SR path, the joint
    training route and the widths past the joint kernel's; their launches
    are added to ``launches``.
    ``split_step_ms``: phase 6's step time, or None when it did not run."""
    model, loader, conv_launches, k1_fused = serve_fused_conv()
    launches['conv3x3_fwd'] = conv_launches
    launches['swin_block_joint_int8_fwd'] = serve_int8(model, loader)
    del model
    serve_and_train_msrresnet()
    launches['swin_block_joint_fwd'] += k1_fused + serve_tiled()
    for name, count in train_joint(split_step_ms).items():
        launches[name] += count
    for name, count in serve_wide_swinir().items():
        launches[name] += count


def main():
    if not torch.cuda.is_available():
        fail('no CUDA device')
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    rs_batch = resshift_options(RS_TRAIN_CONFIG)[0]['datasets']['train']['batch_size_per_gpu']
    l2s_batch = resshift_options(L2S_CONFIG)[0]['datasets']['train']['batch_size_per_gpu']
    build_kernels()
    if sys.argv[1:] == ['serving']:   # development: the serving modes' kernels and paths alone
        print(json.dumps({'swin_block_joint_fwd': check_joint_kernel(), **check_conv_kernel(),
                          **check_int8_block_kernel()}))
        profile_requests(*serve()[:2])
        write_train_inputs()
        serving_modes(collections.Counter(), None)
        return
    kernels = {'swin_block_joint_fwd': check_joint_kernel()}
    kernels.update(check_branch_kernels())
    kernels.update(check_attention_kernels(rs_batch, l2s_batch))
    kernels.update(check_deform_kernels())
    kernels.update(check_conv_kernel())
    kernels.update(check_int8_block_kernel())
    if sys.argv[1:] == ['kernels']:   # development: the kernel phases alone
        print(json.dumps(kernels))
        return
    # each phase below sets its kernels' counts to 0 just before it drives its
    # path and reads them just after
    model, loader, serve_launches = serve()
    profile_requests(model, loader)
    check_whole_model(model, loader)
    del model
    train_launches, split_step_ms, _ = train()
    check_model_gradients()
    # SwinIR's paths: the serving run plus the training run (its validations
    # go through the joint kernel)
    launches = dict(train_launches)
    launches['swin_block_joint_fwd'] += serve_launches
    served = serve_resshift()
    trained = train_resshift()
    check_resshift_gradients()
    l2s = check_l2s_unet()
    launches['window_attention_fwd'] = served + trained['window_attention_fwd'] + l2s[
        'window_attention_fwd']
    launches['window_attention_bwd'] = trained['window_attention_bwd'] + l2s['window_attention_bwd']
    launches.update(deform_sample_fwd=0, deform_sample_bwd=0)
    for i, name in enumerate(VIDEO):
        served, _ = serve_video(name, 11 + 3 * i)
        trained, _, _ = train_video(name, 12 + 3 * i)
        check_video_gradients(name, 13 + 3 * i)
        launches['deform_sample_fwd'] += served + trained['deform_sample_fwd']
        launches['deform_sample_bwd'] += trained['deform_sample_bwd']
    serving_modes(launches, split_step_ms)
    for name, count in launches.items():
        if count == 0:
            fail(f'{name} was never launched on the main paths')
    print(f'total {time.perf_counter() - T0:.1f} s')
    print(card)
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'basicsr4rs_torch/csrc/{name}.cu',
        'replaces': replaces, 'launches': launches[name],
        'max_abs_err': kernels[name]['max_abs_err'], 'ms': kernels[name]['ms'],
        'plain_ms': kernels[name]['plain_ms'], 'bound_ms': kernels[name]['bound_ms'],
        'bound_by': kernels[name]['bound_by'], 'library_ms': kernels[name].get('library_ms'),
        **{k: v for k, v in kernels[name].items() if k not in SUMMARY_KEYS}}
        for name, replaces in KERNELS]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
