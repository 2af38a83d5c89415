"""Process rank helpers (counterpart of ``basicsr4rs_tpu/utils/dist_util.py``;
reference: basicsr/utils/dist_util.py).

The port runs single-process so far: ``get_dist_info`` reads
``torch.distributed`` when a process group exists and is (0, 1) otherwise.
Launching a distributed run comes with the train path.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch.distributed as dist


def get_dist_info() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def master_only(func: Callable) -> Callable:
    """Decorator: run ``func`` on rank 0 only."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper
