"""Rows exchanged between the bands of one image under ``parallel: {spatial:
N}`` (the port's counterpart of what XLA's SPMD partitioner inserts for the
JAX mesh's ``spatial`` axis, ``basicsr4rs_tpu/parallel/mesh.py``).

The ranks of one spatial group hold the same images, each its own band of
rows: band ``r`` of ``N`` is rows ``[r * h, (r + 1) * h)`` of a map of ``N *
h`` rows, at every resolution of the network (a pixel shuffle or a nearest
upsample of a band is the band of the upsampled map). A network reads its
shard from ``current_shard()``, which ``spatial_scope`` sets around its
forward, in the manner of ``ops.dispatch.mesh_info()``; without a scope (or
with one band) every function here is the plain single-map operation.

* ``halo_rows(x, above, below)``: x with its neighbours' rows on either side,
  zeros beyond the global top and bottom (a zero-padded convolution's view);
  its backward sends the halo rows' gradients back to the ranks that own
  those rows, where they are added.
* ``roll_rows(x, shift)``: ``torch.roll`` of the global H axis by ``shift``
  rows (the shifted windows' roll); its backward is the opposite roll.
* ``gather_rows(x)``: the whole map from every band (validation outputs; no
  gradient).
* ``max_over_bands(t)``: the elementwise maximum over the group (an int8
  activation's absmax on a band is the whole map's).
* ``band_of(t, dim)``: this rank's band of a whole tensor.

Only neighbour traffic: each exchange sends a band's edge rows to the rank
above and the rank below (the roll's wrap-around joins the last band to the
first). Sends go out before receives are waited on, as one batch of
point-to-point operations, sends to the previous band first, receives from
the next band first, each with a tag of its direction: with two bands the
previous and the next rank are one rank, and the two messages between them
still pair up in order, on gloo by tag and on NCCL by order. On a gloo group
a CUDA tensor is staged through the host (gloo sends no CUDA tensor): right,
not a rate.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

H_DIM = 2   # NCHW
_TO_PREV, _TO_NEXT = 0, 1   # message tags: toward the band above, the band below


class SpatialShard(NamedTuple):
    """One rank's place in its spatial group: the group, its global ranks in
    band order, and this rank's band."""
    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def global_rows(self, rows: int) -> int:
        """The whole map's height, for a band of ``rows`` rows."""
        return rows * self.size

    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]

    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]


_scope = threading.local()
_GROUPS: Dict[Tuple[int, int], list] = {}


def spatial_groups(spatial: int) -> list:
    """One process group a spatial group (global ranks ``d * spatial ...
    (d + 1) * spatial - 1`` for data rank ``d``), made once a process: every
    rank takes part in making every group, in the same order, as
    ``dist.new_group`` requires."""
    world_size = dist.get_world_size()
    key = (world_size, spatial)
    if key not in _GROUPS:
        _GROUPS[key] = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                        for d in range(world_size // spatial)]
    return _GROUPS[key]


def make_shard(data_rank: int, spatial_rank: int, spatial: int) -> Optional[SpatialShard]:
    """This rank's ``SpatialShard`` (None with one band). Every rank must
    call it, in the same order (``spatial_groups``)."""
    if spatial <= 1:
        return None
    group = spatial_groups(spatial)[data_rank]
    return SpatialShard(group, tuple(range(data_rank * spatial, (data_rank + 1) * spatial)),
                        spatial_rank)


@contextlib.contextmanager
def spatial_scope(shard: Optional[SpatialShard]):
    """Within the block, the networks run on ``shard``'s band (nothing
    changes for None)."""
    stack = _stack()
    stack.append(shard)
    try:
        yield
    finally:
        stack.pop()


def _stack() -> list:
    if not hasattr(_scope, 'stack'):
        _scope.stack = []
    return _scope.stack


def current_shard() -> Optional[SpatialShard]:
    """The innermost scope's shard, or None: one map, plain operations."""
    stack = _stack()
    return stack[-1] if stack else None


def band_rows(t: torch.Tensor, index: int, bands: int, dim: int = H_DIM) -> torch.Tensor:
    """Band ``index`` of ``bands`` equal bands of ``t`` along ``dim``.
    Raises a ``ValueError`` when the size does not divide."""
    rows = t.shape[dim]
    if rows % bands:
        raise ValueError(f'spatial: {rows} rows (dim {dim} of {tuple(t.shape)}) do not split '
                         f'into {bands} equal bands')
    h = rows // bands
    return t.narrow(dim, index * h, h)


def band_of(t: torch.Tensor, shard: Optional[SpatialShard], dim: int = H_DIM) -> torch.Tensor:
    """``shard``'s band of ``t`` along ``dim`` (``band_rows``); ``t`` itself
    without a shard."""
    return t if shard is None else band_rows(t, shard.index, shard.size, dim)


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type == 'cuda' and dist.get_backend(group) == 'gloo'


def _exchange(shard: SpatialShard, to_prev: Optional[torch.Tensor],
              to_next: Optional[torch.Tensor], from_prev: Optional[torch.Size],
              from_next: Optional[torch.Size], like: torch.Tensor, cyclic: bool):
    """Send ``to_prev`` to the band above and ``to_next`` to the band below,
    receive tensors of the shapes ``from_prev`` / ``from_next`` from them
    (None: nothing that way). Without ``cyclic`` the first band has no band
    above and the last none below. Returns (received from prev, from next)."""
    if not cyclic:
        if shard.first:
            to_prev, from_prev = None, None
        if shard.last:
            to_next, from_next = None, None
    staged = _staged(like, shard.group)
    device = torch.device('cpu') if staged else like.device

    def out(t):
        return t.to(device).contiguous()

    ops, got = [], {}
    for tensor, peer, tag in ((to_prev, shard.prev_rank(), _TO_PREV),
                              (to_next, shard.next_rank(), _TO_NEXT)):
        if tensor is not None:
            ops.append(dist.P2POp(dist.isend, out(tensor), peer, shard.group, tag))
    for shape, peer, tag, key in ((from_next, shard.next_rank(), _TO_PREV, 'next'),
                                  (from_prev, shard.prev_rank(), _TO_NEXT, 'prev')):
        if shape is not None:
            got[key] = torch.empty(shape, dtype=like.dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, got[key], peer, shard.group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def back(key):
        t = got.get(key)
        return None if t is None else t.to(like.device, non_blocking=False)
    return back('prev'), back('next')


def _rows(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    return x.narrow(H_DIM, start, n)


def _shape_with_rows(x: torch.Tensor, n: int) -> torch.Size:
    shape = list(x.shape)
    shape[H_DIM] = n
    return torch.Size(shape)


def _zeros_or(t: Optional[torch.Tensor], x: torch.Tensor, n: int) -> torch.Tensor:
    return t if t is not None else x.new_zeros(_shape_with_rows(x, n))


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, above, below, shard):
        ctx.above, ctx.below, ctx.shard = above, below, shard
        h = x.shape[H_DIM]
        # the band above needs my first ``below`` rows, the band below my last ``above``
        top, bottom = _exchange(
            shard, _rows(x, 0, below) if below else None,
            _rows(x, h - above, above) if above else None,
            _shape_with_rows(x, above) if above else None,
            _shape_with_rows(x, below) if below else None, x, cyclic=False)
        return torch.cat([_zeros_or(top, x, above), x, _zeros_or(bottom, x, below)], H_DIM)

    @staticmethod
    def backward(ctx, g):
        above, below, shard = ctx.above, ctx.below, ctx.shard
        h = g.shape[H_DIM] - above - below
        dx = _rows(g, above, h).clone()
        # the halo rows' gradients go back to their owners: the top halo's to
        # the band above, the bottom halo's to the band below
        from_prev, from_next = _exchange(
            shard, _rows(g, 0, above) if above else None,
            _rows(g, above + h, below) if below else None,
            _shape_with_rows(g, below) if below else None,
            _shape_with_rows(g, above) if above else None, g, cyclic=False)
        if from_prev is not None:   # the band above's bottom halo: my first rows
            _rows(dx, 0, below).add_(from_prev)
        if from_next is not None:   # the band below's top halo: my last rows
            _rows(dx, h - above, above).add_(from_next)
        return dx, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """x (B, C, h, W), a band of the current scope's map, with ``above`` rows
    of the band above it and ``below`` rows of the band below it joined on
    (zeros past the map's first and last row): (B, C, above + h + below, W).
    Without a scope, x between zero rows. Differentiable: each halo row's
    gradient is added to the row it came from."""
    shard = current_shard()
    if shard is None:
        return torch.nn.functional.pad(x, (0, 0, above, below))
    h = x.shape[H_DIM]
    if above > h or below > h:
        raise ValueError(f'halo_rows: a band of {h} rows cannot give {max(above, below)} '
                         'halo rows')
    return _HaloRows.apply(x, above, below, shard)


def _roll(x: torch.Tensor, shift: int, shard: SpatialShard) -> torch.Tensor:
    h = x.shape[H_DIM]
    if shift == 0:
        return x
    if shift < 0:   # row i takes row i + s: my rows from s on, then the next band's first s
        s = -shift
        _, from_next = _exchange(shard, _rows(x, 0, s), None, None, _shape_with_rows(x, s), x,
                                 cyclic=True)
        return torch.cat([_rows(x, s, h - s), from_next], H_DIM)
    # row i takes row i - s: the band above's last s rows, then mine up to h - s
    from_prev, _ = _exchange(shard, None, _rows(x, h - shift, shift), _shape_with_rows(x, shift),
                             None, x, cyclic=True)
    return torch.cat([from_prev, _rows(x, 0, h - shift)], H_DIM)


class _RollRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shift, shard):
        ctx.shift, ctx.shard = shift, shard
        return _roll(x, shift, shard)

    @staticmethod
    def backward(ctx, g):
        return _roll(g.contiguous(), -ctx.shift, ctx.shard), None, None


def roll_rows(x: torch.Tensor, shift: int, dim: int = H_DIM) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` of the whole map along its rows (``dim``:
    the H axis of x, 2 for NCHW, 1 for (B, H, W, C)), x a band of the
    current scope's map; ``torch.roll`` itself without a scope. A band must
    hold more rows than ``|shift|``."""
    shard = current_shard()
    if shard is None:
        return torch.roll(x, shift, dims=dim)
    h = x.shape[dim]
    if abs(shift) >= h:
        raise ValueError(f'roll_rows: a band of {h} rows cannot roll by {shift}')
    if dim == H_DIM:
        return _RollRows.apply(x, shift, shard)
    moved = x.movedim(dim, H_DIM)
    return _RollRows.apply(moved, shift, shard).movedim(H_DIM, dim)


@torch.no_grad()
def gather_rows(x: torch.Tensor, shard: Optional[SpatialShard] = None) -> torch.Tensor:
    """The whole map (B, C, N * h, W) from every band x (B, C, h, W) of the
    group (the current scope's unless given), in band order; x itself
    without a shard. Every rank of the group gets it. No gradient."""
    shard = shard or current_shard()
    if shard is None:
        return x
    staged = _staged(x, shard.group)
    local = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(local) for _ in range(shard.size)]
    dist.all_gather(parts, local, group=shard.group)
    return torch.cat(parts, H_DIM).to(x.device)


@torch.no_grad()
def max_over_bands(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of t over every band of the current scope's
    group (each rank passes its own); t itself without a scope."""
    shard = current_shard()
    if shard is None:
        return t
    staged = _staged(t, shard.group)
    local = (t.cpu() if staged else t).clone()
    dist.all_reduce(local, dist.ReduceOp.MAX, group=shard.group)
    return local.to(t.device)


def require_spatial_route(modules: Sequence, kind: str = 'network') -> None:
    """Raise ``NotImplementedError`` for the first of ``modules`` that has no
    spatial route: a network or a loss runs on bands when it declares it
    (``SPATIAL_SHARDING``, a class attribute or a property true for the
    configuration at hand)."""
    for module in modules:
        if not getattr(module, 'SPATIAL_SHARDING', False):
            raise NotImplementedError(
                f'{type(module).__name__}: this {kind} has no spatial route (parallel.spatial > 1 '
                'splits each image\'s rows over the ranks; see ROADMAP Queue 1 for the routes '
                'still to port)')
