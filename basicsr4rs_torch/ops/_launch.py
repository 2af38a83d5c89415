"""What every kernel wrapper does around a launch: bind the library's C
functions, check an operand, find the stream, turn a CUDA error code into an
exception."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ._build import load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {'branch': 0, 'residual': 1, 'scaled': 2}


def bind(name: str, argtypes: Sequence, smem_argtypes: Optional[Sequence],
         grad_floats_argtypes: Optional[Sequence] = None) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with the types of its C
    functions set: ``<name>`` (the launch, returns a cudaError_t),
    ``<name>_error``, for a kernel that takes shared memory
    ``<name>_smem_bytes`` and, for a backward kernel with a gradient buffer,
    ``<name>_grad_floats`` (its size)."""
    lib = load_library(name)
    launch = getattr(lib, name)
    launch.argtypes, launch.restype = list(argtypes), ctypes.c_int
    if smem_argtypes is not None:
        smem = getattr(lib, f'{name}_smem_bytes')
        smem.argtypes, smem.restype = list(smem_argtypes), ctypes.c_size_t
    err = getattr(lib, f'{name}_error')
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    if grad_floats_argtypes is not None:
        floats = getattr(lib, f'{name}_grad_floats')
        floats.argtypes, floats.restype = list(grad_floats_argtypes), ctypes.c_size_t
    return lib


def operand(t: torch.Tensor, name: str, shape, dtype, device) -> torch.Tensor:
    """``t`` cast to ``dtype``; raises unless it has ``shape``, lies on
    ``device``, is contiguous and 16-byte aligned."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, x on {device}')
    t = t.detach().to(dtype)
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'{name} must be 16-byte aligned')
    return t


def scale_operand(residual_scale, x: torch.Tensor):
    """DropPath's per-sample scale (B,) as a float32 operand, or None."""
    if residual_scale is None:
        return None
    return operand(residual_scale, 'residual_scale', (x.shape[0],), torch.float32, x.device)


def check_activation(x: torch.Tensor, name: str, op: str) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f'{op}: {name} must be float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f'{op}: {name} must be contiguous and 16-byte aligned')


def mode_of(add_residual: bool, residual_scale) -> int:
    if residual_scale is not None:
        return MODES['scaled']
    return MODES['residual'] if add_residual else MODES['branch']


_RAW_STREAM = getattr(torch._C, '_cuda_getCurrentRawStream', None)   # CUDA builds only


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``,
    without building a ``torch.cuda.Stream`` object where the build allows."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _RAW_STREAM(torch.cuda.current_device() if device.index is None else device.index)


def stream_of(t: torch.Tensor) -> int:
    """``current_stream`` of the CUDA tensor ``t``'s device."""
    if _RAW_STREAM is None:
        return current_stream(t.device)
    return _RAW_STREAM(t.get_device())


@functools.lru_cache(maxsize=None)
def shared_memory_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def check_shared_memory(needed: int, device: torch.device, op: str) -> None:
    limit = shared_memory_limit(device)
    if needed > limit:
        raise ValueError(f'{op}: needs {needed} bytes of shared memory per block, '
                         f'the device has {limit}')


def check_rc(rc: int, lib: ctypes.CDLL, kernel: str) -> None:
    if rc != 0:
        message = getattr(lib, f'{kernel}_error')(rc).decode()
        raise RuntimeError(f'{kernel} launch failed: CUDA error {rc} ({message})')


def pointers(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]
