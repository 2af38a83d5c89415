"""Process groups and rank helpers (counterpart of
``basicsr4rs_tpu/utils/dist_util.py``; reference: basicsr/utils/dist_util.py).

A data-parallel run is one process per card, started by ``torchrun``
(``python -m torch.distributed.run``) or by Slurm's ``srun``; ``init_dist``
joins this process to the group, NCCL on cards and gloo on the CPU. Without a
launcher nothing is initialised and ``get_dist_info`` is (0, 1).

What the models need of the group: ``all_reduce_sum`` (a sum over the ranks
with a sum over the ranks as its backward), ``all_gather_rows`` (the global
batch's rows), ``global_mean`` (the global batch's mean from sums and
counts) and ``broadcast_module`` (rank 0's weights everywhere). Each is the identity in one process, with no
collective.
"""

from __future__ import annotations

import datetime
import functools
import os
import subprocess
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it fails: a rank
# that died shows as an error, not as a hang
DEFAULT_TIMEOUT_S = 1800
TORCHRUN = 'python -m torch.distributed.run --standalone --nproc_per_node N'


def init_dist(launcher: str, backend: str = 'nccl', use_cuda: bool = True) -> None:
    """Join this process to the group that ``launcher`` started.

    ``pytorch`` (``jax`` is taken as it) reads ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` as torchrun sets them, ``slurm`` reads ``SLURM_PROCID``,
    ``SLURM_NTASKS`` and the node list. With ``use_cuda`` the process takes
    card ``rank % device_count`` before anything is built or launched on one
    (BasicSR's rule: under gloo several ranks may share a card). Raises when
    the launcher's variables are absent and when NCCL is asked for without a
    card. A process already in the group (one that runs several pipelines)
    stays in it, if its rank and size are the launcher's."""
    if launcher == 'jax':
        launcher = 'pytorch'
    if launcher == 'pytorch':
        rank, world_size = _torchrun_env()
    elif launcher == 'slurm':
        rank, world_size = _slurm_env()
    else:
        raise ValueError(f'Invalid launcher type: {launcher}')
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(f'init_dist: this process is rank {dist.get_rank()} of '
                               f'{dist.get_world_size()}, the launcher says {rank} of '
                               f'{world_size}')
        return
    if backend == 'nccl' and not (use_cuda and torch.cuda.is_available()):
        raise RuntimeError('init_dist: backend nccl needs a CUDA device; set num_gpu: 0 '
                           '(gloo on the CPU) or dist_params.backend: gloo')
    if use_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f'init_dist: rank {rank} asks for a CUDA device and sees none; '
                               'set num_gpu: 0 to run on the CPU')
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method='env://', rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def _torchrun_env() -> Tuple[int, int]:
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
               if k not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher pytorch: {", ".join(missing)} not set; start the run '
                           f'with {TORCHRUN} -m basicsr4rs_torch.train -opt <yml> '
                           '--launcher pytorch')
    return int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])


def _slurm_env() -> Tuple[int, int]:
    """Rank and size from Slurm; the first node of the allocation is the
    address (BasicSR's ``_init_dist_slurm``), ``MASTER_PORT`` or 29500 the
    port."""
    missing = [k for k in ('SLURM_PROCID', 'SLURM_NTASKS', 'SLURM_NODELIST')
               if k not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher slurm: {", ".join(missing)} not set; start the run '
                           'with srun')
    rank, world_size = int(os.environ['SLURM_PROCID']), int(os.environ['SLURM_NTASKS'])
    addr = subprocess.getoutput(
        f'scontrol show hostname {os.environ["SLURM_NODELIST"]} | head -n1')
    os.environ.setdefault('MASTER_PORT', '29500')
    os.environ.setdefault('MASTER_ADDR', addr)
    os.environ['WORLD_SIZE'], os.environ['RANK'] = str(world_size), str(rank)
    num_gpus = max(torch.cuda.device_count(), 1)
    os.environ['LOCAL_RANK'] = str(rank % num_gpus)
    return rank, world_size


def get_dist_info() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_device_info() -> Tuple[int, int]:
    """``(local cards, global cards)``: the cards this process sees, and the
    cards the group drives, one a rank (0 on the CPU)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not local:
        return 0, 0
    return local, get_dist_info()[1]


def barrier() -> None:
    """Wait for every rank; nothing in one process."""
    if get_dist_info()[1] > 1:
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def sum_across_processes(arr, device=None) -> np.ndarray:
    """The sum of ``arr`` over the ranks, as numpy: one ``all_reduce(SUM)`` of
    a tensor on ``device`` (the rank's card under NCCL, else the CPU unless
    given). Each rank fills its own rows of zero-initialised metrics and the
    sum merges them; one process gets ``arr`` back."""
    arr = np.asarray(arr)
    if get_dist_info()[1] == 1:
        return arr
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if dist.get_backend() == 'nccl' else torch.device('cpu'))
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce(SUM)`` of a copy, whose backward is again the sum over
    the ranks (differentiable twice over)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor whose backward is
    again the sum over the ranks: a loss every rank computes from it takes
    its gradient from every rank's rows, as the JAX mesh's global-batch loss
    does. Every rank must call it, in the same order. ``t`` itself in one
    process."""
    if get_dist_info()[1] == 1:
        return t
    return _SumOverRanks.apply(t)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order (each rank must hold as many),
    differentiable: each rank's rows in a zero buffer of the global batch,
    summed by ``all_reduce_sum`` (gloo gathers no CUDA tensor; it sums
    them). ``t`` in one process."""
    rank, world_size = get_dist_info()
    if world_size == 1:
        return t
    zeros = torch.zeros_like(t)
    return all_reduce_sum(torch.cat([t if r == rank else zeros for r in range(world_size)]))


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the entries of every rank, from their sums and
    counts in one ``all_reduce_sum``: uneven rows per rank still give the
    global batch's mean, with its gradient. ``t.mean()`` in one process."""
    if get_dist_info()[1] == 1:
        return t.mean()
    total = all_reduce_sum(torch.stack([t.sum().float(), t.new_tensor(t.numel(),
                                                                      dtype=torch.float32)]))
    return (total[0] / total[1]).to(t.dtype)


@torch.no_grad()
def broadcast_module(net: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank, in place: one
    ``broadcast`` of a flat buffer for each dtype. Nothing in one process."""
    if get_dist_info()[1] == 1:
        return
    tensors = list(net.parameters()) + list(net.buffers())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, value in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(value.view(t.shape))


def close_dist() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def master_only(func: Callable) -> Callable:
    """Decorator: run ``func`` on rank 0 only."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper
