"""The ranks as a (data, spatial) grid, and what a model needs of it
(counterpart of ``basicsr4rs_tpu/parallel/mesh.py``).

The JAX package declares shardings over a device mesh and XLA compiles the
gradient all-reduce. Here each rank is one process on one card: its loader
yields its own rows (``data.loader.EnlargedSampler`` strides the permutation
by rank), ``shard_batch`` puts them on its card, and ``replicate`` wraps a
trained network in ``DistributedDataParallel``, which broadcasts rank 0's
weights at the start (the JAX package's process-identical init) and averages
the gradients in each backward.

Config (``opt['parallel']``)::

    parallel:
      data: -1        # -1 = every rank
      spatial: 1      # > 1 (H-sharding with halo exchange) is not ported
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.dist_util import get_dist_info


def create_mesh(opt: Optional[Dict[str, Any]] = None,
                world_size: Optional[int] = None) -> Tuple[int, int]:
    """``(data, spatial)``: the axes of ``opt['parallel']`` over the group's
    ranks (all on the data axis by default). Raises when ``data x spatial``
    is not the rank count, and on ``spatial > 1``."""
    size = get_dist_info()[1] if world_size is None else world_size
    par = (opt or {}).get('parallel') or {}
    spatial = int(par.get('spatial', 1))
    data = int(par.get('data', -1))
    if data == -1:
        data = size // spatial
    if data * spatial != size:
        raise ValueError(f'parallel axes data={data} x spatial={spatial} != world size {size}')
    if spatial > 1:
        raise NotImplementedError('parallel.spatial > 1 (H-sharding with halo exchange) is not '
                                  'ported (ROADMAP Queue 1, item 5)')
    return data, spatial


def shard_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """This rank's batch on its card: tensors moved, the rest (paths) kept."""
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


def replicate(net: nn.Module, device: torch.device, find_unused_parameters: bool = False,
              broadcast_buffers: bool = True) -> nn.Module:
    """``net`` wrapped in ``DistributedDataParallel`` over the group (on
    ``device``, a card or the CPU). Needs an initialised process group."""
    from torch.nn.parallel import DistributedDataParallel
    # named only when it departs from DDP's default, which newer torch
    # releases warn about naming at all
    extra = {} if broadcast_buffers else {'broadcast_buffers': False}
    return DistributedDataParallel(
        net, device_ids=[device] if device.type == 'cuda' else None,
        find_unused_parameters=find_unused_parameters, **extra)
