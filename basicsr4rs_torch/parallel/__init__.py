"""Data parallelism (counterpart of ``basicsr4rs_tpu/parallel/``)."""

from .mesh import create_mesh, replicate, shard_batch

__all__ = ['create_mesh', 'replicate', 'shard_batch']
