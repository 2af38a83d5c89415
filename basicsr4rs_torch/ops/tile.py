"""Batched tiled inference (counterpart of ``basicsr4rs_tpu/ops/tile.py``).

An input larger than one forward holds is cut into overlapping windows that
all run as ONE batch, and the upscaled cores are stitched back. Windows are
edge-anchored: each lies fully inside the image (shifted inward at the
borders), so an edge window ends at the true image boundary and the model's
own padding applies there. A CNN's result is therefore exact once
``tile_pad`` covers its receptive field; a window-attention model sees only
its tile, as in the reference's tile mode.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], lq: torch.Tensor, scale: int,
                tile_size: int, tile_pad: int = 16) -> torch.Tensor:
    """Apply ``fn`` (NCHW -> NCHW, upscaling by ``scale``) to ``lq`` as one
    batch of tiles.

    Args:
      fn: forward over a batch of tiles.
      lq: (N, C, H, W) input.
      scale: spatial upscale factor of ``fn``.
      tile_size: core tile size in input pixels.
      tile_pad: halo around each core in input pixels.
    Returns: (N, C_out, H*scale, W*scale).
    """
    n, _, h, w = lq.shape
    full = tile_size + 2 * tile_pad
    if full >= h or full >= w:
        return fn(lq)

    def axis_plan(extent):
        """(window_start, core_start in the window, core_len) per tile."""
        plan = []
        for i in range(math.ceil(extent / tile_size)):
            core0 = i * tile_size
            core_len = min(tile_size, extent - core0)
            win0 = min(max(core0 - tile_pad, 0), extent - full)
            plan.append((win0, core0 - win0, core_len))
        return plan

    rows, cols = axis_plan(h), axis_plan(w)
    tiles = [lq[:, :, wy:wy + full, wx:wx + full] for wy, _, _ in rows for wx, _, _ in cols]
    out = fn(torch.cat(tiles, dim=0))
    out = out.reshape(len(rows), len(cols), n, -1, full * scale, full * scale)

    s = scale
    strips = []
    for ri, (_, oy, ly) in enumerate(rows):
        strip = [out[ri, ci, :, :, oy * s:(oy + ly) * s, ox * s:(ox + lx) * s]
                 for ci, (_, ox, lx) in enumerate(cols)]
        strips.append(torch.cat(strip, dim=3))
    return torch.cat(strips, dim=2)
