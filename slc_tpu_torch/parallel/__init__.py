"""Multi-device scaling: image-tile parallelism with halo exchange, on
``torch.distributed`` (port of slc_tpu/parallel).

slc_tpu is single-controller (one process drives a ``Mesh`` through
``shard_map``); the port is SPMD, one process (rank) per device:

* ``mesh``: (scan, ty, tx) ``DeviceMesh`` construction (``None`` is the
  1x1x1 mesh of a process with no process group);
* ``halo``: neighbour exchange by ``batch_isend_irecv``, and the counted
  collectives;
* ``tiled``, ``unwrap_tiled``, ``fusion_tiled``: the pipeline stages on
  this rank's tile (or landmark shard), returning this rank's tile;
* ``launch``: joining a cluster (NCCL on the cards, gloo on the CPU) and
  :class:`~slc_tpu_torch.parallel.launch.LocalCluster`.
"""

from slc_tpu_torch.parallel.mesh import tile_mesh, TILE_Y, TILE_X, SCAN
from slc_tpu_torch.parallel import launch
from slc_tpu_torch.parallel.halo import halo_exchange, halo_crop
from slc_tpu_torch.parallel.tiled import (
    tiled_absolute_decode,
    tiled_heterodyne_decode,
    tiled_stripe_regression,
    tiled_dynamic_step,
    tiled_batched_dynamic_step,
    shard_image,
    gather_image,
)
from slc_tpu_torch.parallel.unwrap_tiled import tiled_unwrap_spatial

__all__ = [
    "tile_mesh", "TILE_Y", "TILE_X", "SCAN", "launch",
    "halo_exchange", "halo_crop",
    "tiled_absolute_decode", "tiled_heterodyne_decode",
    "tiled_stripe_regression", "tiled_dynamic_step",
    "tiled_batched_dynamic_step", "tiled_unwrap_spatial", "shard_image",
    "gather_image",
]
