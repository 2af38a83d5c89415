"""The ranks as a (data, spatial) grid, and what a model needs of it
(counterpart of ``basicsr4rs_tpu/parallel/mesh.py``).

The JAX package declares shardings over a device mesh and XLA compiles the
gradient all-reduce. Here each rank is one process on one card: its loader
yields its own rows (``data.loader.EnlargedSampler`` strides the permutation
by rank) and ``shard_batch`` puts them on its card. A network's gradient
becomes the global batch's by one of two routes:

* ``replicate`` wraps it in ``DistributedDataParallel``, which broadcasts
  rank 0's weights at the start (the JAX package's process-identical init)
  and averages the gradients inside the backward. It fits a step with one
  forward through the wrapper and one backward of each network;
* ``average_gradients`` averages them once, in one flat buffer, just before
  the optimizer steps: what the JAX step's one ``value_and_grad`` of the
  global loss amounts to. The GAN, StyleGAN2 and joint-align steps take
  this route (a network without gradient in one phase, a double backward,
  a gated update, a network reached through its methods); their weights
  start from ``dist_util.broadcast_module``.

Either way ``sync_statistics`` turns on the global-batch statistics that
the JAX mesh takes over the sharded batch (``sync_ranks``: the BatchNorm of
``arch_util._FlaxBatchStats``, SPADE's and the PatchGAN's ``batch`` norm,
StyleGAN2's minibatch stddev).

Config (``opt['parallel']``)::

    parallel:
      data: -1        # -1 = every rank
      spatial: 1      # > 1 (H-sharding with halo exchange) is not ported
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
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


def sync_statistics(net: nn.Module) -> None:
    """The train-mode statistics of every module of ``net`` that has
    ``sync_ranks`` taken over the ranks' rows together."""
    for m in net.modules():
        if hasattr(m, 'sync_ranks'):
            m.sync_ranks = True


@torch.no_grad()
def average_gradients(*nets: nn.Module) -> None:
    """Each parameter's gradient replaced by its mean over the ranks, in
    place: one ``all_reduce`` of a flat buffer per dtype, copied back in
    each gradient's own strides (K3 and K5 hand back views of one buffer).
    Parameters without a gradient take no part; a step where none has one
    (a gated update) exchanges nothing. Every rank must have gradients for
    the same parameters. Nothing in one process."""
    world_size = get_dist_info()[1]
    if world_size == 1:
        return
    grads = [p.grad for net in nets for p in net.parameters() if p.grad is not None]
    for dtype in dict.fromkeys(g.dtype for g in grads):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat.div_(world_size)
        torch._foreach_copy_(group, [v.view(g.shape) for v, g in
                                     zip(flat.split([g.numel() for g in group]), group)])
