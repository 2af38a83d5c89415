"""The forward kernels of an exported image network as PyTorch operators of
the namespace ``basicsr4rs``.

``torch.export`` cannot trace through a ctypes launch on raw ``data_ptr()``s,
so each such kernel is defined once here as an operator with three
implementations: ``CPU``, its plain PyTorch version; ``CUDA``, the ctypes
launch, which alone adds one to the kernel's ``.launches`` count; and a fake
one that gives the output's shape, dtype and strides for tracing. No other
device has an implementation, so a call on one raises. An exported graph
keeps each kernel as one node (``basicsr4rs.<name>.default``), and a loaded
artifact launches and counts it as a live forward does.

The ops live beside their wrappers: ``ops.swin_block`` defines
``swin_block_joint_fwd`` (K1) and ``swin_attn_block_fwd`` (K2),
``ops.mlp_block`` ``mlp_block_fwd`` (K4) and ``ops.conv3x3`` ``conv3x3_fwd``
(K10). ``register_all`` imports those modules and nothing else of the
package, which is what loading an artifact needs.
"""

from __future__ import annotations

import importlib
from typing import Callable

import torch

NAMESPACE = 'basicsr4rs'
OP_MODULES = ('swin_block', 'mlp_block', 'conv3x3')
LIBRARY = torch.library.Library(NAMESPACE, 'DEF')


def define(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable) -> None:
    """Define ``basicsr4rs::<name>(<schema>) -> Tensor`` with its CPU, CUDA
    and fake implementations."""
    LIBRARY.define(f'{name}({schema}) -> Tensor')
    LIBRARY.impl(name, cpu, 'CPU')
    LIBRARY.impl(name, cuda, 'CUDA')
    torch.library.register_fake(f'{NAMESPACE}::{name}', fake, lib=LIBRARY)


def like_x(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """The fake implementation of an op whose output is a contiguous tensor
    of x's shape and dtype."""
    return x.new_empty(x.shape)


def check_device(x: torch.Tensor, op: str) -> None:
    """Raises unless ``x`` lies on the CPU (the plain version) or a card (the
    kernel): the ops have no implementation for any other device."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{op}: no kernel for device {x.device}')


def register_all() -> None:
    """Import the modules that define the ops, and no other of the package."""
    for name in OP_MODULES:
        importlib.import_module(f'{__package__}.{name}')
