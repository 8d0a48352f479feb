"""The grid of ranks of width-sharded serving (port of
rdfc_gan_tpu/parallel/mesh.py: ``make_mesh`` with a ``model`` axis, and
``spatial_sharding``).

A ``mesh_shape`` ``{"data": D, "model": M}`` lays the D * M ranks out as
``make_mesh`` lays out devices, row-major: rank (d, m) is ``d * M + m``
(mesh.py:22-33). Rank (d, m) holds rows ``d`` of the global batch (block d
of D, as ``rank_rows`` takes them over the world) and columns
[m W / M, (m + 1) W / M) of the input and the outputs:
``spatial_sharding``'s ``P(None, None, "model", None)`` on NHWC arrays
(mesh.py:82-89), here the last axis of NCHW ones; W must be a multiple of
M, as ``device_put`` requires. Inside the nets an activation of global
width W_l is laid out as XLA lays out an uneven shard: every rank holds
c_l = ceil(W_l / M) columns (``shard_cols``), rank m the global columns
[m c_l, (m + 1) c_l) (``owned``), and the columns at or past W_l, on the
last ranks, are padding (``valid_cols`` counts a rank's image columns; a
rank may hold none). A ``model`` process group holds each data row (the
ranks that share rows and split the width), a ``data`` group each column;
every rank makes every group, in the same order, as ``dist.new_group``
requires.

``shard_width`` and ``gather_width`` are the counterparts of
``device_put`` with ``spatial_sharding`` and of reading a sharded result
back; ``rank_rows(x, d, D)`` takes a data row's block of a global batch.
The rules a sharded forward follows are in ``parallel.spatial``; the
exchanges in ``parallel.halo``. A grid with M = 1 shards nothing: its forwards run as
before, each data row on its rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import halo
from .dist import check_mesh_shape, mesh_axes, rank, world_size


class Grid(NamedTuple):
    """This rank's place in a ``data`` x ``model`` grid: (d, m) of (D, M),
    and the process groups of its data row (``model_group``, the ranks
    that split its width) and of its column (``data_group``); a group is
    None where it has one rank."""
    D: int
    M: int
    d: int
    m: int
    model_group: Optional[object]
    data_group: Optional[object]


def make_grid(mesh_shape=None) -> Grid:
    """The grid of ``mesh_shape`` over the ranks of the default process
    group (checked by ``check_mesh_shape``: the axes are ``data`` and
    ``model`` and their product is the world size). Every rank must call it,
    in the same order as its other collectives: it makes every row's and
    every column's group."""
    world = world_size()
    check_mesh_shape(mesh_shape, world)
    D, M = mesh_axes(mesh_shape, world)
    r = rank()
    d, m = divmod(r, M)
    model_group = data_group = None
    if world > 1:
        for row in range(D):
            g = dist.new_group([row * M + j for j in range(M)])
            if row == d:
                model_group = g
        for col in range(M):
            g = dist.new_group([i * M + col for i in range(D)])
            if col == m:
                data_group = g
    return Grid(D, M, d, m, model_group if M > 1 else None,
                data_group if D > 1 else None)


def shard_cols(W: int, M: int) -> int:
    """c = ceil(W / M): the columns every rank holds of a width W."""
    return -(-W // M)


def owned(W: int, M: int, m: int) -> Tuple[int, int]:
    """Rank m's global columns [m c, (m + 1) c) of a width W."""
    c = shard_cols(W, M)
    return m * c, (m + 1) * c


def valid_cols(W: int, M: int, m: int) -> int:
    """How many of rank m's columns of a width W lie inside the image (its
    first ones; the rest are padding)."""
    c = shard_cols(W, M)
    return min(max(W - m * c, 0), c)


def shard_width(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's columns of a (..., W) tensor: block m of M, contiguous."""
    W = x.shape[-1]
    if W % grid.M:
        raise ValueError(f"width {W} does not split over {grid.M} ranks")
    w = W // grid.M
    return x[..., grid.m * w:(grid.m + 1) * w].contiguous()


def gather_width(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole width of a tensor whose last axis is sharded over the
    ``model`` group: the M shards side by side, on every rank of the row."""
    if grid.M == 1:
        return x
    return halo.all_gather_width(x, grid.model_group, grid.M)
