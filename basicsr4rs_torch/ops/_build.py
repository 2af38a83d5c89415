"""Build the port's CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library at first
use, under ``build/kernels/`` at the root of the checkout, named by a hash of
the source and the flags, so an edited source builds anew and an unchanged
one is built once. The compiler's output (``-Xptxas=-v``: registers, shared
memory, spills) is kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (set CUDA_HOME): the CUDA kernels '
                           'are built with nvcc at first use')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; return the library's path."""
    src = CSRC_DIR / f'{name}.cu'
    key = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f'{name}-{key}.so'
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {src}:\n{proc.stdout}{proc.stderr}')
    lib.with_name(lib.name + '.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
