"""Real-ESRGAN's two-stage degradation synthesis on the model's device
(counterpart of ``basicsr4rs_tpu/ops/degradation_pipeline.py``; reference:
basicsr/models/realesrgan_model.py:68-185). NCHW float32 batches.

The JAX package's numbers, not BasicSR's eager ones, are what the port
holds to, and they depend on two of its choices, which the port keeps:

* **Static canvases.** The stage-1 resize renders the scaled image into the
  top-left of a canvas of ``ceil(ori * resize_range[1])`` (600 for a 400
  crop) and zeroes the rest; noise and JPEG run on the whole canvas, so the
  zero background reaches the valid region's edge through the resize
  weights, the blur and JPEG's boundary blocks. Stage 2 maps the valid
  region onto a canvas of ``ceil(ori / scale * resize_range2[1])``, and the
  last resize lands on the LQ size. The shapes never change from step to
  step, which also keeps cuDNN's plans and the allocator steady.
* **The resize is ``jax.image.scale_and_translate``**, not
  ``F.interpolate``: 'area' is its linear kernel with antialiasing,
  'bilinear' its linear kernel, 'bicubic' Keys' cubic with a = -0.5
  (torch's bicubic is a = -0.75), and each output pixel's weights are
  normalised over the input samples inside the whole input array (the
  canvas, background included). ``resize_matrix`` builds the (out, in)
  weights of one axis on the device from the drawn scale; a resize is two
  batched matmuls with it.

The draws are separate from the arithmetic. ``RealESRGANDegrader.draw``
samples everything random: the batch-level choices (up / down / keep and
the resize method of each stage, Gaussian or Poisson noise, the second
blur, the final order) and the two stages' scales from a host
``np.random.Generator``, so that no Python branch reads the device; the
per-sample sigmas, scales, gray flags and JPEG qualities, and the noise
fields, from a ``torch.Generator`` on the device. ``apply`` is
deterministic given the draws, which a test may build itself.

JPEG's ``round(dct / (table * factor))`` and the final ``round(255 x)`` flip
on errors of 1e-3, so ``apply`` runs cuDNN and cuBLAS with TF32 off
(``full_float32``) whatever the caller set.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..data.degradations import (gaussian_fields, gaussian_noise, poisson_fields,
                                 poisson_noise)
from ..utils.diffjpeg import DiffJPEG
from ..utils.img_process_util import USMSharp, filter2D

RESIZE_MODES = ('up', 'down', 'keep')
RESIZE_METHODS = ('area', 'bilinear', 'bicubic')


@contextlib.contextmanager
def full_float32():
    """cuDNN's convolutions and cuBLAS's matmuls in full float32 (no TF32)
    inside; the previous settings come back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., 0., out)


def resize_matrix(in_size: int, out_size: int, scale, method: int, valid: int,
                  device=None) -> torch.Tensor:
    """The (out_size, in_size) float32 weights with which
    ``jax.image.scale_and_translate`` (translation 0) resamples one axis by
    ``scale`` (a float32 value) with ``RESIZE_METHODS[method]``; the rows
    of output pixels at or past ``valid`` are zero."""
    inv_scale = np.float32(1) / np.float32(scale)
    kernel_scale = max(inv_scale, np.float32(1)) if method == 0 else np.float32(1)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * float(
        inv_scale) - 0.5
    x = (sample_f[:, None] - torch.arange(in_size, dtype=torch.float32, device=device)).abs()
    x = x / float(kernel_scale)
    weights = _keys_cubic(x) if method == 2 else torch.clamp(1 - x, min=0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000. * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1), 0)
    keep = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    keep &= torch.arange(out_size, device=device) < valid
    return torch.where(keep[:, None], weights, 0)


def resize(img: torch.Tensor, out_size: int, in_valid: int, out_valid: int,
           method: int) -> torch.Tensor:
    """``img`` (N, C, S, S), whose top-left ``in_valid`` square is the image,
    resampled so that it fills the top-left ``out_valid`` square of an
    ``out_size`` canvas (zero outside)."""
    scale = np.float32(out_valid) / np.float32(in_valid)
    weights = resize_matrix(img.shape[-1], out_size, scale, method, out_valid, img.device)
    return torch.matmul(torch.matmul(weights, img), weights.t())


def _valid_mask(size: int, valid: int, device) -> torch.Tensor:
    inside = torch.arange(size, device=device) < valid
    return (inside[:, None] & inside[None, :]).float()


@dataclass
class NoiseDraw:
    """One stage's noise: Gaussian (``level`` is sigma in 255 units,
    ``fields`` the colour and gray normal fields) or Poisson (``level`` is
    the scale, ``fields`` the (u, z) pairs of the colour and the gray
    sampler); ``gray`` is 1. for a sample that takes gray noise."""
    gaussian: bool
    level: torch.Tensor
    gray: torch.Tensor
    fields: Tuple[Any, Any]


@dataclass
class SynthesisDraws:
    """Every random choice of one ``RealESRGANDegrader.apply``: host values
    for the batch-level ones, device tensors for the per-sample ones."""
    resize1: str            # RESIZE_MODES
    scale1: np.float32
    method1: int            # index into RESIZE_METHODS
    noise1: NoiseDraw
    jpeg_q1: torch.Tensor   # (N,)
    blur2: bool
    resize2: str
    scale2: np.float32
    method2: int
    noise2: NoiseDraw
    method3: int
    jpeg_q2: torch.Tensor
    resize_first: bool      # final order: resize + sinc, then JPEG; else the other way

    def branches(self) -> Dict[str, Any]:
        """The batch-level branch each choice took."""
        return {'resize1': self.resize1, 'method1': RESIZE_METHODS[self.method1],
                'noise1': 'gaussian' if self.noise1.gaussian else 'poisson',
                'blur2': self.blur2, 'resize2': self.resize2,
                'method2': RESIZE_METHODS[self.method2],
                'noise2': 'gaussian' if self.noise2.gaussian else 'poisson',
                'method3': RESIZE_METHODS[self.method3],
                'order': 'resize+sinc, jpeg' if self.resize_first else 'jpeg, resize+sinc'}


class RealESRGANDegrader:
    """(gt, kernel1, kernel2, sinc_kernel) -> (lq, gt, gt_usm) for an NCHW
    batch of square crops; the kernels are (N, 21, 21). The options are the
    model's (``resize_prob``, ``noise_range``, ``jpeg_range`` and the
    rest, each stage's). Float32 with TF32 off (``full_float32``)."""

    def __init__(self, opt: Dict[str, Any]):
        self.opt = opt
        self.scale = opt['scale']
        self.jpeger = DiffJPEG(differentiable=False)
        self.usm = USMSharp()

    def to(self, device):
        self.jpeger.to(device)
        self.usm.to(device)
        return self

    def canvases(self, ori: int) -> Tuple[int, int]:
        """The stage-1 and stage-2 canvas sizes for crops of ``ori``."""
        return (int(math.ceil(ori * self.opt['resize_range'][1])),
                int(math.ceil(ori / self.scale * self.opt['resize_range2'][1])))

    # ------------------------------------------------------------------ draws
    def draw_noise(self, suffix: str, gaussian: bool, shape: Sequence[int],
                   generator: torch.Generator, device=None) -> NoiseDraw:
        """Stage 1's (``suffix`` '') or stage 2's ('2') noise of the kind
        ``gaussian`` picks, on a canvas batch of ``shape``: per-sample level
        and gray flag, then the fields, from ``generator``."""
        o = self.opt
        n, c, h, w = shape
        span = o['noise_range' + suffix] if gaussian else o['poisson_scale_range' + suffix]
        level = torch.empty(n, device=device).uniform_(*span, generator=generator)
        gray = (torch.rand(n, device=device, generator=generator)
                < o['gray_noise_prob' + suffix]).float()
        fields = (gaussian_fields(shape, generator, device) if gaussian else
                  (poisson_fields(shape, generator, device),
                   poisson_fields((n, 1, h, w), generator, device)))
        return NoiseDraw(gaussian, level, gray, fields)

    def draw(self, shape: Sequence[int], rng: np.random.Generator,
             generator: torch.Generator, device=None) -> SynthesisDraws:
        """The draws of one batch of ``shape`` (N, C, ori, ori): batch-level
        from ``rng`` on the host, per-sample and the noise fields from
        ``generator`` on ``device``."""
        o = self.opt
        n, c, ori, _ = shape
        canvas1, canvas2 = self.canvases(ori)

        def qualities(span):
            return torch.empty(n, device=device).uniform_(*span, generator=generator)

        def resize_draw(prob, span):
            mode = RESIZE_MODES[rng.choice(3, p=prob)]
            scale = {'up': lambda: rng.uniform(1, span[1]),
                     'down': lambda: rng.uniform(span[0], 1), 'keep': lambda: 1.}[mode]()
            return mode, np.float32(scale)

        def noise_draw(suffix, size):
            gaussian = bool(rng.uniform() < o['gaussian_noise_prob' + suffix])
            return self.draw_noise(suffix, gaussian, (n, c, size, size), generator, device)

        resize1, scale1 = resize_draw(o['resize_prob'], o['resize_range'])
        method1 = int(rng.integers(3))
        noise1 = noise_draw('', canvas1)
        jpeg_q1 = qualities(o['jpeg_range'])
        blur2 = bool(rng.uniform() < o['second_blur_prob'])
        resize2, scale2 = resize_draw(o['resize_prob2'], o['resize_range2'])
        method2 = int(rng.integers(3))
        noise2 = noise_draw('2', canvas2)
        method3 = int(rng.integers(3))
        jpeg_q2 = qualities(o['jpeg_range2'])
        resize_first = bool(rng.uniform() < 0.5)
        return SynthesisDraws(resize1, scale1, method1, noise1, jpeg_q1, blur2, resize2, scale2,
                              method2, noise2, method3, jpeg_q2, resize_first)

    # ------------------------------------------------------------- arithmetic
    @staticmethod
    def _add_noise(img, noise: NoiseDraw):
        if noise.gaussian:
            out = img + gaussian_noise(noise.level, noise.gray, noise.fields)
        else:
            out = img + poisson_noise(img, noise.level, noise.gray, *noise.fields)
        return torch.clamp(out, 0, 1)

    def apply(self, gt, kernel1, kernel2, sinc_kernel, d: SynthesisDraws):
        """(lq, gt, gt_usm) from the draws ``d``; deterministic."""
        _, _, ori, ori_w = gt.shape
        if ori != ori_w:
            raise ValueError(f'square crops expected, got {ori}x{ori_w}')
        canvas1, canvas2 = self.canvases(ori)
        lq_size = ori // self.scale
        with full_float32():
            gt_usm = self.usm(gt)

            # stage 1: blur, resize onto the canvas, noise, JPEG
            out = filter2D(gt_usm, kernel1)
            valid1 = int(np.floor(np.float32(ori) * d.scale1))
            out = resize(out, canvas1, ori, valid1, d.method1)
            out = self._add_noise(out, d.noise1)
            out = self.jpeger(out * _valid_mask(canvas1, valid1, out.device), d.jpeg_q1)

            # stage 2: blur, resize onto the second canvas, noise
            if d.blur2:
                out = filter2D(out, kernel2)
            valid2 = int(np.floor(np.float32(ori / self.scale) * d.scale2))
            out = resize(out, canvas2, valid1, valid2, d.method2)
            out = self._add_noise(out, d.noise2)

            # the final resize + sinc filter and JPEG, in the drawn order
            if d.resize_first:
                out = filter2D(resize(out, lq_size, valid2, lq_size, d.method3), sinc_kernel)
                out = self.jpeger(torch.clamp(out, 0, 1), d.jpeg_q2)
            else:
                out = torch.clamp(out, 0, 1) * _valid_mask(canvas2, valid2, out.device)
                out = self.jpeger(out, d.jpeg_q2)
                out = filter2D(resize(out, lq_size, valid2, lq_size, d.method3), sinc_kernel)
            lq = torch.clamp((out * 255.0).round(), 0, 255) / 255.
        return lq, gt, gt_usm

    def __call__(self, gt, kernel1, kernel2, sinc_kernel, rng, generator):
        return self.apply(gt, kernel1, kernel2, sinc_kernel,
                          self.draw(gt.shape, rng, generator, gt.device))


def paired_random_crop_traced(gts, lq, gt_size: int, scale: int, top: int, left: int):
    """The aligned crop at LQ offset (``top``, ``left``): ``gt_size`` of
    each GT batch in ``gts`` (one tensor or a list) and ``gt_size //
    scale`` of ``lq``; the offsets come from ``crop_offsets``."""
    lq_size = gt_size // scale
    lq_crop = lq[..., top:top + lq_size, left:left + lq_size]
    single = not isinstance(gts, (list, tuple))
    out = [g[..., top * scale:top * scale + gt_size, left * scale:left * scale + gt_size]
           for g in ([gts] if single else gts)]
    return (out[0] if single else out), lq_crop


def crop_offsets(rng: np.random.Generator, lq_hw: Tuple[int, int], lq_size: int):
    """A uniform (top, left) of an ``lq_size`` crop of an ``lq_hw`` map."""
    return (int(rng.integers(0, lq_hw[0] - lq_size + 1)),
            int(rng.integers(0, lq_hw[1] - lq_size + 1)))


class TrainingPairPool:
    """The training-pair pool on the device (BasicSR's
    ``_dequeue_and_enqueue``): until ``queue_size`` pairs are in, each batch
    is stored and passes through; from then on the pool is permuted
    (``torch.randperm`` from the given generator, or ``perm``), its first
    batch goes out and the new batch takes its place. ``swaps`` counts
    those exchanges."""

    def __init__(self, queue_size: int):
        self.queue_size = queue_size
        self.lq = self.gt = None
        self.ptr = 0
        self.swaps = 0

    def update(self, lq, gt, generator=None, perm=None):
        b, qs = lq.shape[0], self.queue_size
        if qs % b != 0:
            raise ValueError(f'queue size {qs} should be divisible by batch size {b}')
        if self.lq is None:
            self.lq = lq.new_zeros((qs,) + tuple(lq.shape[1:]))
            self.gt = gt.new_zeros((qs,) + tuple(gt.shape[1:]))
        if self.ptr < qs:
            self.lq[self.ptr:self.ptr + b] = lq
            self.gt[self.ptr:self.ptr + b] = gt
            self.ptr += b
            return lq, gt
        if perm is None:
            perm = torch.randperm(qs, generator=generator, device=lq.device)
        self.lq, self.gt = self.lq[perm], self.gt[perm]
        lq_out, gt_out = self.lq[:b].clone(), self.gt[:b].clone()
        self.lq[:b] = lq
        self.gt[:b] = gt
        self.swaps += 1
        return lq_out, gt_out
