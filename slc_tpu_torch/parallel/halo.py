"""Halo exchange and the counted collectives of the tile-parallel paths
(port of slc_tpu/parallel/halo.py on ``torch.distributed``).

Each rank holds one (h, w) image tile. Windowed stencils (21-row box
sums CCalculation.cpp:797-823, +-10 px extremum search :837-850, 3x3
blur :650) need up to 11 px of neighbour data. :func:`halo_axis` fetches
both slabs of one mesh axis in one ``dist.batch_isend_irecv`` over the
axis's global ranks; a rank at the mesh edge gets zeros for the missing
neighbour, as ``ppermute`` gives, which matches the reference's zero
border for valSum and keeps the interior masks (applied in global
coordinates) exact. :func:`halo_exchange` runs the y axis first and the
x axis on the y-extended tile, so that corners arrive.

``COUNTS`` holds the bytes each rank takes in, by collective, in the
categories of slc_tpu's ``hlo_collective_bytes`` (slc_tpu/devtime.py:91):
every halo slab a rank receives, zero-filled ones included, as
``ppermute``'s result shape counts; each all-reduce's tensor once; each
all-gather's result. ``devtime.collective_bytes`` reads them for one
call.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from slc_tpu_torch.parallel.mesh import (TILE_X, TILE_Y, axis_index,
                                         axis_neighbours, axis_size)

COUNTS = {"collective-permute": 0, "all-reduce": 0, "all-gather": 0,
          "ops": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _count(kind: str, nbytes: int, ops: int = 1) -> None:
    COUNTS[kind] += nbytes
    COUNTS["ops"] += ops


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def halo_axis(x: torch.Tensor, halo: int, dim: int, mesh,
              axis: str) -> torch.Tensor:
    """Extend tile ``x`` by ``halo`` entries of neighbour data on both
    sides of tensor dimension ``dim`` (sharded along mesh dim ``axis``)."""
    if halo == 0:
        return x
    n = x.shape[dim]
    # Column slabs are strided views: send contiguous copies.
    to_next = x.narrow(dim, n - halo, halo).contiguous()
    to_prev = x.narrow(dim, 0, halo).contiguous()
    lo = torch.zeros_like(to_next)       # from the neighbour above/left
    hi = torch.zeros_like(to_prev)       # from the neighbour below/right
    prev, nxt = axis_neighbours(mesh, axis)
    ops = []
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, to_next, nxt),
                dist.P2POp(dist.irecv, hi, nxt)]
    if prev is not None:
        ops += [dist.P2POp(dist.isend, to_prev, prev),
                dist.P2POp(dist.irecv, lo, prev)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("collective-permute", _nbytes(lo) + _nbytes(hi), ops=2)
    return torch.cat([lo, x, hi], dim)


def halo_exchange(x: torch.Tensor, halo_y: int, halo_x: int,
                  mesh) -> torch.Tensor:
    """2-D halo exchange: (..., h, w) tile -> (..., h + 2*halo_y,
    w + 2*halo_x), y first, then x on the y-extended tile."""
    x = halo_axis(x, halo_y, x.dim() - 2, mesh, TILE_Y)
    return halo_axis(x, halo_x, x.dim() - 1, mesh, TILE_X)


def halo_crop(x: torch.Tensor, halo_y: int, halo_x: int) -> torch.Tensor:
    """Crop a halo-extended tile back to its core, contiguous (the tiles
    a tiled function returns go on to kernels that take contiguous
    maps)."""
    h, w = x.shape[-2], x.shape[-1]
    return x[..., halo_y:h - halo_y, halo_x:w - halo_x].contiguous()


def global_offsets(tile_h: int, tile_w: int, mesh):
    """(row0, col0) global coordinates of this tile's origin."""
    return (axis_index(mesh, TILE_Y) * tile_h,
            axis_index(mesh, TILE_X) * tile_w)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` unchanged). With
    no group (the 1x1x1 mesh) the identity."""
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    _count("all-reduce", _nbytes(out))
    return out


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The tiles of ``group``'s ranks concatenated along ``dim`` in group
    rank order (the list form of all_gather, which gloo has too)."""
    if group is None:
        _count("all-gather", _nbytes(x))
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _count("all-gather", _nbytes(out))
    return out


def axis_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """All-gather the tiles of this rank's line along mesh dim ``axis``,
    concatenated along ``dim`` in axis order."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return all_gather_cat(x, dim, None)
    return all_gather_cat(x, dim, mesh.get_group(axis))
