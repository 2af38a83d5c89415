"""Build the port's CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface, over the
device code they share in ``csrc/*.cuh``. It is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library at first use, under
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the headers and the flags, so an edited source or header builds anew
and an unchanged one is built once. ``build_all`` compiles several kernels
at once, one ``nvcc`` each. The compiler's output (``-Xptxas=-v``: registers, shared
memory, spills) is kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v', '-I', str(CSRC_DIR))
KERNELS = ('swin_block_joint_fwd', 'swin_attn_block_fwd', 'swin_attn_block_bwd',
           'mlp_block_fwd', 'mlp_block_bwd', 'window_attention_fwd', 'window_attention_bwd',
           'deform_sample_fwd', 'deform_sample_bwd', 'conv3x3_fwd',
           'swin_block_joint_int8_fwd')


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (set CUDA_HOME): the CUDA kernels '
                           'are built with nvcc at first use')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` that has no library of the same
    sources and flags, all at once; return the libraries' paths by name."""
    libs = {name: _library_path(name) for name in names}
    missing = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not missing:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, lib in missing.items():
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        src = CSRC_DIR / f'{name}.cu'
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in running:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f'nvcc failed on {src}:\n{output}')
            continue
        lib.with_name(lib.name + '.log').write_text(output)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError('\n'.join(failures))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags exists; return the library's path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
