"""Data parallelism and the spatial axis (counterpart of
``basicsr4rs_tpu/parallel/``)."""

from .halo import (current_shard, gather_rows, halo_rows, require_spatial_route, roll_rows,
                   spatial_scope)
from .mesh import (Grid, average_gradients, create_mesh, opt_grid, rank_grid, replicate,
                   shard_batch, sync_statistics)

__all__ = ['Grid', 'average_gradients', 'create_mesh', 'current_shard', 'gather_rows',
           'halo_rows', 'opt_grid', 'rank_grid', 'replicate', 'require_spatial_route', 'roll_rows',
           'shard_batch', 'spatial_scope', 'sync_statistics']
