"""Device meshes for structured-light workloads (port of
slc_tpu/parallel/mesh.py on ``torch.distributed``).

Axes, as in slc_tpu:

* ``SCAN``: data parallelism over independent scans or streaming batches;
* ``TILE_Y`` / ``TILE_X``: image-tile parallelism, each rank owning an
  (H/ty, W/tx) block of the camera image; windowed ops exchange halos of
  up to 11 px (RECO_WINDOW_SIZE=21, StaticParameters.cpp:38).

slc_tpu is single-controller: one process drives a ``Mesh`` of devices.
The port is SPMD, one process (rank) per device, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, dims named (``SCAN``, ``TILE_Y``, ``TILE_X``),
rank r at position r of the row-major (scan, ty, tx) grid. Without a
process group there is one rank, and its mesh is ``None``: every
function of :mod:`slc_tpu_torch.parallel` takes ``None`` as the 1x1x1
mesh, whose halos are zeros and whose reductions are identities.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

SCAN = "scan"
TILE_Y = "ty"
TILE_X = "tx"

#: The (ty, tx) plane groups made by :func:`tile_group`, by mesh layout.
_TILE_GROUPS: dict = {}


def _near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n = a*b with a <= b and a maximal (closest to sqrt)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def mesh_shape(world: int, scan: int = 1,
               tiles: Optional[Tuple[int, int]] = None
               ) -> Tuple[int, int, int]:
    """The (scan, ty, tx) grid of ``world`` ranks: the per-scan count
    factored near-square with the larger factor on ``tx`` (image width
    is the last dimension), or ``tiles`` checked against it."""
    if world % scan:
        raise ValueError(f"{world} devices not divisible by scan={scan}")
    per_scan = world // scan
    if tiles is None:
        ty, tx = _near_square_factors(per_scan)
    else:
        ty, tx = tiles
        if ty * tx != per_scan:
            raise ValueError(
                f"tiles {ty}x{tx} != devices-per-scan {per_scan}")
    return scan, ty, tx


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def tile_mesh(world: Optional[int] = None, scan: int = 1,
              tiles: Optional[Tuple[int, int]] = None):
    """A (scan, ty, tx) mesh over ranks 0..world-1, by default every rank
    of the process group. Every rank of the process group must call it,
    as every collective. Without a process group ``world`` must be 1 and
    the mesh is ``None`` (the 1x1x1 mesh)."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(world, scan, tiles)
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(
                f"a mesh of {world} ranks needs a process group "
                f"(parallel.launch.initialize)")
        return None
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(), torch.arange(world).reshape(shape),
                      mesh_dim_names=(SCAN, TILE_Y, TILE_X))


def mesh_dims(mesh) -> dict:
    """{dim name: size}, as slc_tpu's ``mesh.shape``."""
    if mesh is None:
        return {SCAN: 1, TILE_Y: 1, TILE_X: 1}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def tile_counts(mesh) -> Tuple[int, int]:
    """(ty, tx) tile grid of a mesh built by :func:`tile_mesh`."""
    dims = mesh_dims(mesh)
    return dims[TILE_Y], dims[TILE_X]


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh_dims(mesh)[name]


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along mesh dim ``name``."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def axis_neighbours(mesh, name: str) -> Tuple[Optional[int], Optional[int]]:
    """Global ranks of this rank's predecessor and successor along
    ``name`` (None at the mesh edge)."""
    if mesh is None:
        return None, None
    dim = mesh.mesh_dim_names.index(name)
    coord = mesh.get_coordinate()
    out = []
    for step in (-1, 1):
        c = list(coord)
        c[dim] += step
        inside = 0 <= c[dim] < mesh.mesh.shape[dim]
        out.append(int(mesh.mesh[tuple(c)]) if inside else None)
    return out[0], out[1]


def tile_group(mesh):
    """The process group of this rank's (ty, tx) plane: the ranks of its
    scan group. Made on first use for each mesh layout; every rank of the
    process group makes every plane's group, in the same order, so every
    rank must reach the first use together, as a collective."""
    if mesh is None:
        return None
    key = (mesh.device_type, tuple(mesh.mesh.shape),
           tuple(mesh.mesh.flatten().tolist()))
    if key not in _TILE_GROUPS:
        me = dist.get_rank()
        mine = None
        for plane in mesh.mesh.reshape(mesh.mesh.shape[0], -1).tolist():
            group = dist.new_group(plane)
            if me in plane:
                mine = group
        _TILE_GROUPS[key] = mine
    return _TILE_GROUPS[key]


def world_group(mesh):
    """The process group of every rank of ``mesh``: the default group
    when the mesh spans it."""
    if mesh is None:
        return None
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the mesh does not span the process group")
    return dist.group.WORLD


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh`` (its current CUDA device on a CUDA
    mesh); None for the 1x1x1 mesh, whose tensors stay where they are."""
    if mesh is None:
        return None
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
