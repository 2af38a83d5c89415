"""Data parallelism (counterpart of ``basicsr4rs_tpu/parallel/``)."""

from .mesh import average_gradients, create_mesh, replicate, shard_batch, sync_statistics

__all__ = ['average_gradients', 'create_mesh', 'replicate', 'shard_batch', 'sync_statistics']
