"""The ranks as a (data, spatial) grid, and what a model needs of it
(counterpart of ``basicsr4rs_tpu/parallel/mesh.py``).

The JAX package declares shardings over a device mesh and XLA compiles the
gradient all-reduce and the halo exchanges. Here each rank is one process on
one card, and world rank r sits at ``(data_rank, spatial_rank) = divmod(r,
spatial)``: the row-major order of the JAX ``dev_array.reshape(data,
spatial)``. The ranks of one spatial group hold the same images; its loader
yields the data rank's rows (``data.loader.EnlargedSampler`` strides the
permutation by data rank) and ``shard_batch`` puts them on the rank's card,
with ``spatial_sharded`` only its band of each image's rows (dim 2 of NCHW,
dim 3 of (B, T, C, H, W), as ``batch_spec``). The networks that run on bands
exchange rows with the neighbouring bands (``parallel/halo.py``). A
network's gradient becomes the global batch's by one of two routes:

* ``replicate`` wraps it in ``DistributedDataParallel``, which broadcasts
  rank 0's weights at the start (the JAX package's process-identical init)
  and averages the gradients inside the backward. It fits a step with one
  forward through the wrapper and one backward of each network, on the
  data axis alone;
* ``average_gradients`` averages them once over every rank, in one flat
  buffer, just before the optimizer steps: what the JAX step's one
  ``value_and_grad`` of the global loss amounts to. The GAN, StyleGAN2 and
  joint-align steps take this route (a network without gradient in one
  phase, a double backward, a gated update, a network reached through its
  methods), and every model under ``spatial > 1``, so that the halo
  exchanges of the backward never interleave with DDP's bucket hooks; their
  weights start from ``dist_util.broadcast_module``. Bands are equal, so the
  mean of the ranks' per-band means is the global mean, and the mean of
  their gradients the global loss's.

Either way ``sync_statistics`` turns on the global-batch statistics that
the JAX mesh takes over the sharded batch (``sync_ranks``: the BatchNorm of
``arch_util._FlaxBatchStats``, SPADE's and the PatchGAN's ``batch`` norm,
StyleGAN2's minibatch stddev).

Config (``opt['parallel']``)::

    parallel:
      data: -1        # -1 = every rank not on the spatial axis
      spatial: 1      # > 1: each image's rows split over that many ranks

Sizing rule for ``spatial > 1`` (``docs/Config.md``): ``H / spatial`` a
multiple of the window of at least two window rows, so that each band holds
whole windows and a shifted window's roll reaches only the next band.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.dist_util import get_dist_info
from .halo import band_rows


def create_mesh(opt: Optional[Dict[str, Any]] = None,
                world_size: Optional[int] = None) -> Tuple[int, int]:
    """``(data, spatial)``: the axes of ``opt['parallel']`` over the group's
    ranks (all on the data axis by default). Raises a ``ValueError`` when
    ``data x spatial`` is not the rank count."""
    size = get_dist_info()[1] if world_size is None else world_size
    par = (opt or {}).get('parallel') or {}
    spatial = int(par.get('spatial', 1))
    data = int(par.get('data', -1))
    if data == -1 and spatial >= 1:
        data = size // spatial
    if spatial < 1 or data * spatial != size:
        raise ValueError(f'parallel axes data={data} x spatial={spatial} != world size {size}')
    return data, spatial


class Grid(NamedTuple):
    """A rank's place on the (data, spatial) grid."""
    data: int
    spatial: int
    data_rank: int
    spatial_rank: int


def rank_grid(opt: Optional[Dict[str, Any]], rank: int, world_size: int) -> Grid:
    """World rank ``rank`` on the grid of ``opt['parallel']``:
    ``(data_rank, spatial_rank) = divmod(rank, spatial)``."""
    data, spatial = create_mesh(opt, world_size)
    return Grid(data, spatial, *divmod(rank, spatial))


def opt_grid(opt: Dict[str, Any]) -> Grid:
    """This process's place on the grid of a parsed config: its ``rank``
    and ``world_size`` on ``parallel`` under a launcher (``opt['dist']``),
    else the one-rank grid."""
    if not opt.get('dist'):
        return Grid(1, 1, 0, 0)
    return rank_grid(opt, opt.get('rank', 0), opt.get('world_size', 1))


def _band(v: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Band ``grid.spatial_rank`` of a batch tensor's H (dim 2 of NCHW,
    dim 3 of (B, T, C, H, W)); lower ranks are kept whole."""
    if v.dim() < 4:
        return v
    return band_rows(v, grid.spatial_rank, grid.spatial, v.dim() - 2)


def shard_batch(batch: Dict[str, Any], device: torch.device, spatial_sharded: bool = False,
                grid: Optional[Grid] = None) -> Dict[str, Any]:
    """This rank's batch on its card: tensors moved, the rest (paths) kept.
    With ``spatial_sharded`` and ``grid.spatial > 1``, only the rank's band
    of each image tensor's rows (the JAX package's ``batch_spec``); every
    tensor is checked before any is moved: a ``ValueError`` when an H does
    not divide by ``spatial``."""
    if spatial_sharded and grid is not None and grid.spatial > 1:
        batch = {k: _band(v, grid) if torch.is_tensor(v) else v for k, v in batch.items()}
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
    """Each parameter's gradient replaced by its mean over every rank (both
    axes of the grid), in place: one ``all_reduce`` of a flat buffer per dtype, copied back in
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
