"""Ahead-of-time serving through ``torch.export`` (counterpart of
``basicsr4rs_tpu/utils/serving.py``).

The network is exported once per static (batch, H, W) input *bucket*; each
artifact holds the graph and the weights, so that ``ServingModel`` serves a
directory of them with no model code, no registry and no retrace. The port's
forward kernels are operators of the namespace ``basicsr4rs``
(``ops/library.py``), so an exported SwinIR keeps K1 (or K2 and K4 past its
widths), and K10 under ``SWIN_FUSED_CONV=1``, as single nodes, and a loaded
artifact launches them as the live network does. Switches read while the
network runs (``SWIN_FUSED_CONV``, ``quantized_inference``) are read at
export: an artifact keeps the route that was on then.

A request is reflect-padded up to the smallest bucket that fits (as
``models/swinir_model.py`` pads to the window), its batch zero-padded up to
the bucket's, and the output cropped back to ``(b, c, h*scale, w*scale)``.
On a bucket-exact request the artifact gives the live network's bits.

A torch artifact is tied to the device it was exported on: the manifest
names it (``device``), where the JAX package's took ``platforms``. Both
entry points run on the card unless ``device='cpu'`` is given, and raise
without one.

Artifact layout (one directory per exported model)::

    manifest.json                 # scale, in_chans, dtype, pad_multiple, quant, device, buckets, meta
    net_{H}x{W}_b{B}.pt2          # torch.export.save of one bucket

Written by ``basicsr4rs_torch/scripts/export_serving.py``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from os import path as osp
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ['export_network', 'save_serving_dir', 'ServingModel']

_MANIFEST = 'manifest.json'
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _bucket_name(h: int, w: int, b: int) -> str:
    return f'net_{h}x{w}_b{b}.pt2'


def serving_device(device=None) -> torch.device:
    """``device``, the card when None; raises when it names a card and there
    is none."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass device="cpu" to export or serve on the CPU')
    return device


def export_network(net: torch.nn.Module, batch: int, height: int, width: int,
                   in_chans: int = 3, dtype: torch.dtype = torch.float32, device=None,
                   quant_act_scales: Optional[dict] = None):
    """``torch.export.export`` of ``net`` in eval for one static NCHW shape
    under ``torch.no_grad()``: an ``ExportedProgram`` holding the weights.

    ``net`` is left as it is: a copy is cast to ``dtype`` and moved to
    ``device`` (the card when None). ``quant_act_scales`` (from
    ``ops.quant.calibrate_act_scales``) bakes the W8A8 static-scale mode
    into the graph, ``quantized_inference(net, act_scales=...)`` with
    SwinIR's blocks in float (``swin_kernels=False``), as the JAX exporter
    does. One live forward runs first, so that the constants the network
    caches (SwinIR's window index and shift masks) are real tensors that
    the graph shares."""
    from ..ops.quant import quantized_inference
    device = serving_device(device)
    net = copy.deepcopy(net).to(device=device, dtype=dtype).eval()
    example = torch.zeros(batch, in_chans, height, width, dtype=dtype, device=device)
    scope = (contextlib.nullcontext() if quant_act_scales is None else
             quantized_inference(net, act_scales=quant_act_scales))
    with scope, torch.no_grad():
        net(example)
        return torch.export.export(net, (example,), strict=False)


def save_serving_dir(out_dir: str, net: torch.nn.Module, buckets, *, scale: int,
                     in_chans: int = 3, batch: int = 1, dtype: torch.dtype = torch.float32,
                     pad_multiple: int = 1, device=None, meta: Optional[dict] = None,
                     quant_act_scales: Optional[dict] = None) -> dict:
    """Export every (H, W) bucket and write the serving directory; returns
    the manifest. ``pad_multiple`` is the network's alignment (SwinIR's
    window): a bucket that is not a multiple of it raises."""
    device = serving_device(device)
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for h, w in buckets:
        if h % pad_multiple or w % pad_multiple:
            raise ValueError(f'bucket {h}x{w} not a multiple of {pad_multiple}')
        exported = export_network(net, batch, h, w, in_chans=in_chans, dtype=dtype,
                                  device=device, quant_act_scales=quant_act_scales)
        fname = _bucket_name(h, w, batch)
        torch.export.save(exported, osp.join(out_dir, fname))
        entries.append({'h': h, 'w': w, 'batch': batch, 'file': fname})
    manifest = {
        'scale': scale,
        'in_chans': in_chans,
        'dtype': str(dtype).replace('torch.', ''),
        'pad_multiple': pad_multiple,
        'quant': 'int8-static' if quant_act_scales is not None else None,
        'device': device.type,
        'buckets': sorted(entries, key=lambda e: e['h'] * e['w']),
        'meta': meta or {},
    }
    with open(osp.join(out_dir, _MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingModel:
    """Serve a directory written by :func:`save_serving_dir` on ``device``
    (the card when None), which must be the device it was exported on.

    ``run(x)`` takes an NCHW (or CHW) tensor or array, picks the smallest
    bucket that fits, reflect-pads H and W to it and zero-pads the batch,
    runs the loaded graph and returns the NCHW output cropped back to
    ``(b, c, h*scale, w*scale)`` on ``device``. Loading imports only the
    port's operator definitions, none of its networks."""

    def __init__(self, model_dir: str, device=None):
        from ..ops import library
        library.register_all()
        self.device = serving_device(device)
        with open(osp.join(model_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest['device'] != self.device.type:
            raise ValueError(f'{model_dir} was exported on {self.manifest["device"]}, '
                             f'not {self.device.type}')
        self.scale = int(self.manifest['scale'])
        self.in_chans = int(self.manifest['in_chans'])
        self.dtype = DTYPES[self.manifest['dtype']]
        self._fns = []
        for e in self.manifest['buckets']:
            program = torch.export.load(osp.join(model_dir, e['file']))
            self._fns.append((int(e['h']), int(e['w']), int(e['batch']), program.module()))

    @property
    def buckets(self):
        return [(h, w) for h, w, _, _ in self._fns]

    def _pick(self, h: int, w: int):
        for bh, bw, bb, fn in self._fns:   # sorted by area at save time
            if bh >= h and bw >= w:
                return bh, bw, bb, fn
        raise ValueError(f'no bucket fits {h}x{w}; available: {self.buckets}')

    def run(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.dim() == 3:
            x = x[None]
        b, c, h, w = x.shape
        if c != self.in_chans:
            raise ValueError(f'expected {self.in_chans} channels, got {c}')
        bh, bw, bb, fn = self._pick(h, w)
        if b > bb:
            raise ValueError(f'batch {b} exceeds exported batch {bb}')
        if bh - h >= h or bw - w >= w:
            raise ValueError(f'bucket {bh}x{bw} pads {h}x{w} beyond reflect limits; '
                             'export a closer bucket')
        xp = x.to(device=self.device, dtype=self.dtype)
        if (bh, bw) != (h, w):
            xp = F.pad(xp, (0, bw - w, 0, bh - h), mode='reflect')
        if bb > b:
            xp = torch.cat([xp, xp.new_zeros((bb - b, c, bh, bw))])
        with torch.no_grad():
            out = fn(xp)
        s = self.scale
        return out[:b, :, :h * s, :w * s]
