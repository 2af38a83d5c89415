"""Optical-flow files (counterpart of ``basicsr4rs_tpu/utils/flow_util.py``;
reference: basicsr/utils/flow_util.py): Middlebury ``.flo`` files, and flows
quantised to 8 bits and stored as one image of dx and dy side by side.
numpy on the host."""

from __future__ import annotations

import os

import cv2
import numpy as np

_FLO_MAGIC = 'PIEH'


def flowread(flow_path, quantize: bool = False, concat_axis: int = 0, *args, **kwargs):
    """An (h, w, 2) float32 flow from a ``.flo`` file, or with ``quantize``
    from an image holding the quantised dx and dy stacked along
    ``concat_axis`` (the rest of the arguments go to ``dequantize_flow``)."""
    if quantize:
        if concat_axis not in (0, 1):
            raise ValueError(f'concat_axis must be 0 or 1, got {concat_axis}')
        cat_flow = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if cat_flow.ndim != 2:
            raise IOError(f'{flow_path} is not a valid quantized flow file, '
                          f'its dimension is {cat_flow.ndim}.')
        if cat_flow.shape[concat_axis] % 2:
            raise IOError(f'{flow_path}: an odd size along axis {concat_axis}')
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        flow = dequantize_flow(dx, dy, *args, **kwargs)
    else:
        with open(flow_path, 'rb') as f:
            try:
                header = f.read(4).decode('utf-8')
            except UnicodeDecodeError:
                raise IOError(f'Invalid flow file: {flow_path}')
            if header != _FLO_MAGIC:
                raise IOError(f'Invalid flow file: {flow_path}, header does not contain PIEH')
            w = int(np.fromfile(f, np.int32, 1).squeeze())
            h = int(np.fromfile(f, np.int32, 1).squeeze())
            flow = np.fromfile(f, np.float32, w * h * 2).reshape((h, w, 2))
    return flow.astype(np.float32)


def flowwrite(flow, filename, quantize: bool = False, concat_axis: int = 0, *args, **kwargs):
    """Write an (h, w, 2) flow losslessly as ``.flo``, or with ``quantize``
    as an image of the quantised dx and dy stacked along ``concat_axis``
    (the rest of the arguments go to ``quantize_flow``)."""
    if not quantize:
        with open(filename, 'wb') as f:
            f.write(_FLO_MAGIC.encode('utf-8'))
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
            f.flush()
    else:
        if concat_axis not in (0, 1):
            raise ValueError(f'concat_axis must be 0 or 1, got {concat_axis}')
        dx, dy = quantize_flow(flow, *args, **kwargs)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        cv2.imwrite(filename, np.concatenate((dx, dy), axis=concat_axis))


def quantize_flow(flow, max_val: float = 0.02, norm: bool = True):
    """dx and dy (divided by the width and the height with ``norm``), each
    clipped to [-max_val, max_val] and quantised to 255 uint8 levels."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8) for d in (dx, dy))


def dequantize_flow(dx, dy, max_val: float = 0.02, denorm: bool = True):
    """The inverse of ``quantize_flow``: an (h, w, 2) flow of the levels'
    centres (times the width and the height with ``denorm``)."""
    if dx.shape != dy.shape:
        raise ValueError(f'dx and dy differ in shape: {dx.shape}, {dy.shape}')
    if not (dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)):
        raise ValueError(f'dx and dy must be (h, w) or (h, w, 1), got {dx.shape}')
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def quantize(arr, min_val, max_val, levels: int, dtype=np.int64):
    """Values clipped to [min_val, max_val] as bins 0 to ``levels - 1``."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f'levels must be a positive integer, but got {levels}')
    if min_val >= max_val:
        raise ValueError(f'min_val ({min_val}) must be smaller than max_val ({max_val})')
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val)).astype(dtype), levels - 1)


def dequantize(arr, min_val, max_val, levels: int, dtype=np.float64):
    """Bins 0 to ``levels - 1`` as the centres of their ranges."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f'levels must be a positive integer, but got {levels}')
    if min_val >= max_val:
        raise ValueError(f'min_val ({min_val}) must be smaller than max_val ({max_val})')
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val
