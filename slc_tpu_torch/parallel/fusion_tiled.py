"""Distributed bundle adjustment: landmarks sharded across ranks (port of
slc_tpu/parallel/fusion_tiled.py on ``torch.distributed``).

Every Schur term is a sum over landmarks (``fusion``), so each rank owns
a landmark shard and reduces its local Gauss-Newton blocks, one SUM
all-reduce forms the global reduced camera system, the small (6S x 6S)
solve is replicated, and the landmark back-substitution stays local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from slc_tpu_torch import fusion
from slc_tpu_torch.parallel.halo import all_reduce
from slc_tpu_torch.parallel.mesh import _device_type, world_group

LM = "lm"


def fusion_mesh(world: Optional[int] = None):
    """A 1-D mesh, dim ``LM``, over ranks 0..world-1 (every rank of the
    process group by default); ``None`` (one rank) without a process
    group. Every rank must call it, as every collective."""
    if not dist.is_initialized():
        if world not in (None, 1):
            raise RuntimeError(f"a mesh of {world} ranks needs a process "
                               f"group (parallel.launch.initialize)")
        return None
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size() if world is None else world
    return DeviceMesh(_device_type(), torch.arange(n), mesh_dim_names=(LM,))


def shard_landmarks(mesh, obs, mask, landmarks=None):
    """This rank's landmark slice of (S, L, 3) obs, (S, L) mask and
    (L, 3) landmarks: L split evenly over the mesh."""
    n = 1 if mesh is None else mesh.mesh.numel()
    i = 0 if mesh is None else mesh.get_local_rank(LM)
    l = mask.shape[1]
    if l % n:
        raise ValueError(f"{l} landmarks not divisible over {n} ranks")
    sl = slice(i * (l // n), (i + 1) * (l // n))
    out = [obs[:, sl].contiguous(), mask[:, sl].contiguous()]
    if landmarks is not None:
        out.append(landmarks[sl].contiguous())
    return tuple(out)


@fusion.highest_precision
def tiled_fuse_scans(obs: torch.Tensor, mask: torch.Tensor, mesh,
                     init_rot: Optional[torch.Tensor] = None,
                     init_trans: Optional[torch.Tensor] = None,
                     iters: int = 10, damping: float = 1e-6):
    """Distributed ``fusion.fuse_scans`` on this rank's landmark shard
    (:func:`shard_landmarks`); slc_tpu's defaults (damping 1e-6). Returns
    (rot (S,3,3), trans (S,3)), the same on every rank, and this rank's
    landmarks (L/n, 3). The all-reduced normal equations are exact sums,
    so the poses are the single-device solver's up to the order of
    summation."""
    s = obs.shape[0]
    rot = (init_rot if init_rot is not None
           else torch.eye(3, dtype=obs.dtype, device=obs.device)
           .expand(s, 3, 3))
    trans = (init_trans if init_trans is not None
             else torch.zeros((s, 3), dtype=obs.dtype, device=obs.device))
    pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    lm = ((pred * mask[..., None]).sum(dim=0)
          / mask.sum(dim=0)[:, None].clamp_min(1.0))
    group = world_group(mesh)

    def reduce_fn(v):
        return all_reduce(v, group)

    info = torch.zeros((), dtype=torch.int64, device=obs.device)
    for _ in range(iters):
        rot, trans, lm, i = fusion._gn_step(rot, trans, lm, obs, mask,
                                            damping, reduce_fn)
        info = info + i
    fusion.check_info(info, "tiled_fuse_scans")
    return rot, trans, lm
