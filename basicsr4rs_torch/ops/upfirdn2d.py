"""upfirdn2d: upsample by zero-stuffing, FIR filter, downsample (counterpart
of ``basicsr4rs_tpu/ops/upfirdn2d.py``; reference:
basicsr/ops/upfirdn2d/upfirdn2d.py, whose CUDA kernel neither package
ports: the JAX package runs one XLA convolution, with no Pallas kernel).

NCHW, depthwise: one ``F.conv2d`` with ``groups = C`` and the flipped
kernel (a true convolution, as the reference's) on the input zero-stuffed
to ``H * up`` (torch's ``up - 1`` trailing zeros included) and padded,
with stride ``down``. A negative pad crops.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def make_resample_kernel(k: Sequence[float]) -> torch.Tensor:
    """1D magnitudes -> their normalised outer product (a 2D kernel as it
    is, normalised)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Union[Tuple[int, int], Tuple[int, int, int, int]] = (0, 0)) -> torch.Tensor:
    """``pad`` is (pad0, pad1) on both axes, or (x0, x1, y0, y1)."""
    if len(pad) == 2:
        pad_x0, pad_x1 = pad_y0, pad_y1 = pad
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, c, h, w = x.shape
    if up > 1:   # each sample followed by up - 1 zeros on both axes
        x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(pad_x0, 0), max(pad_x1, 0), max(pad_y0, 0), max(pad_y1, 0)])
    x = x[:, :, max(-pad_y0, 0):x.shape[2] - max(-pad_y1, 0),
          max(-pad_x0, 0):x.shape[3] - max(-pad_x1, 0)]
    kh, kw = kernel.shape
    weight = torch.flip(kernel, (0, 1)).to(x)[None, None].expand(c, 1, kh, kw)
    return F.conv2d(x, weight, stride=down, groups=c)


def upfirdn_upsample(x, kernel, factor: int = 2):
    """Upsample by ``factor`` with the kernel scaled by ``factor ** 2``."""
    kernel = kernel * (factor ** 2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1, pad=((p + 1) // 2 + factor - 1, p // 2))


def upfirdn_downsample(x, kernel, factor: int = 2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def upfirdn_smooth(x, kernel, upsample_factor: int = 1, downsample_factor: int = 1,
                   kernel_size: int = 1):
    """The smoothing filter around a strided (transposed) convolution of
    ``kernel_size``: after a x2 transposed one (the kernel scaled by
    ``up ** 2``) or before a stride-2 one."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
        p = (kernel.shape[0] - upsample_factor) - (kernel_size - 1)
        pad = ((p + 1) // 2 + upsample_factor - 1, p // 2 + 1)
    elif downsample_factor > 1:
        p = (kernel.shape[0] - downsample_factor) + (kernel_size - 1)
        pad = ((p + 1) // 2, p // 2)
    else:
        raise NotImplementedError
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)
