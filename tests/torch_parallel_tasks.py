"""Rank-side tasks of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_launch.py, tests/test_torch_multiprocess.py).

A ``LocalCluster`` rank imports a task by name, so this module imports
only numpy, torch and slc_tpu_torch: a rank must import neither jax nor
slc_tpu. Each task runs on every rank of the cluster at once, builds its
mesh, cuts its tile of the numpy inputs, runs the tiled function and
returns the gathered result as numpy (the same on every rank).
"""

import sys

import numpy as np
import torch

from slc_tpu_torch import devtime
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.dynamic import TrackerState
from slc_tpu_torch.parallel import (SCAN, TILE_X, TILE_Y, gather_image,
                                    launch, shard_image, tile_mesh,
                                    tiled_absolute_decode,
                                    tiled_batched_dynamic_step,
                                    tiled_dynamic_step,
                                    tiled_heterodyne_decode,
                                    tiled_stripe_regression,
                                    tiled_unwrap_spatial)
from slc_tpu_torch.parallel.fusion_tiled import (fusion_mesh,
                                                 shard_landmarks,
                                                 tiled_fuse_scans)
from slc_tpu_torch.parallel.halo import all_gather_cat, all_reduce, axis_gather
from slc_tpu_torch.parallel.mesh import mesh_dims, world_group

STATE = ("proj_u", "strip_w", "strip_b", "z")


def _tables(cfg):
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    return build_tables(calib, cfg.cam_h, cfg.cam_w, device="cpu")


def _tile(a, mesh):
    return shard_image(torch.from_numpy(np.ascontiguousarray(a)), mesh)


def _frame(res, mesh):
    return {k: gather_image(getattr(res, k), mesh).numpy()
            for k in ("x", "y", "z", "proj_u")}


def foreign_modules():
    """Modules of jax or slc_tpu this rank has imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "slc_tpu"))


def mesh_shapes():
    return (mesh_dims(tile_mesh()),
            mesh_dims(tile_mesh(scan=2, tiles=(2, 2))))


def round_trip(x, tiles):
    mesh = tile_mesh(tiles=tiles)
    tile = _tile(x, mesh)
    return tuple(tile.shape), gather_image(tile, mesh).numpy()


def absolute(gray, phase, cfg, tiles):
    mesh = tile_mesh(tiles=tiles)
    res = tiled_absolute_decode(_tile(gray, mesh), _tile(phase, mesh),
                                _tables(cfg), cfg, mesh)
    return _frame(res, mesh)


def heterodyne(imgs, cfg, het, tiles):
    mesh = tile_mesh(tiles=tiles)
    res = tiled_heterodyne_decode(_tile(imgs, mesh), _tables(cfg), cfg,
                                  het, mesh)
    return _frame(res, mesh)


def stripe(frame, cfg, tiles, subpixel):
    mesh = tile_mesh(tiles=tiles)
    sw, sb = tiled_stripe_regression(_tile(frame, mesh), cfg, mesh,
                                     subpixel)
    return gather_image(sw, mesh).numpy(), gather_image(sb, mesh).numpy()


def dynamic(state, frames, cfg, tiles):
    """Step the tiled tracker over ``frames``; every frame's maps."""
    mesh = tile_mesh(tiles=tiles)
    tables = _tables(cfg)
    st = TrackerState(**{k: _tile(state[k], mesh) for k in STATE},
                      frame_idx=int(state["frame_idx"]))
    out = []
    for frame in frames:
        st, res = tiled_dynamic_step(st, _tile(frame, mesh), tables, cfg,
                                     mesh)
        maps = _frame(res, mesh)
        maps.update(strip_w=gather_image(st.strip_w, mesh).numpy(),
                    strip_b=gather_image(st.strip_b, mesh).numpy())
        out.append(maps)
    return out


def batched(states, frames, cfg, scan, tiles):
    """One tiled_batched_dynamic_step over (S, H, W) stacks, each rank
    feeding its scan group's rows through shard_host_batch."""
    mesh = launch.global_tile_mesh(scan=scan, tiles=tiles)
    rows = launch.local_scan_slice(mesh, frames.shape[0])
    spec = (SCAN, TILE_Y, TILE_X)

    def feed(a):
        return launch.shard_host_batch(mesh, a[rows], spec, device="cpu")

    st = TrackerState(**{k: feed(states[k]) for k in STATE}, frame_idx=0)
    new, res, met = tiled_batched_dynamic_step(st, feed(frames),
                                               _tables(cfg), cfg, mesh)
    return {"z": gather_image(res.z, mesh, scan=True).numpy(),
            "proj_u": gather_image(res.proj_u, mesh, scan=True).numpy(),
            "valid_frac": float(met["valid_frac"]),
            "mean_z": float(met["mean_z"]), "frame_idx": new.frame_idx}


def unwrap(psi, t, quality, anchor, tiles, max_iters):
    mesh = tile_mesh(tiles=tiles)
    got, info = tiled_unwrap_spatial(
        _tile(psi, mesh), t, mesh, quality=_tile(quality, mesh),
        max_iters=max_iters, anchor=_tile(anchor, mesh), return_info=True)
    return {"p": gather_image(got, mesh).numpy(),
            "suspect": gather_image(info["suspect"], mesh).numpy(),
            "cg_iters": info["cg_iters"],
            "rel_residual": float(info["rel_residual"]),
            **{k: int(info[k]) for k in ("residue_count", "suspect_count",
                                         "anchor_disagreement_count")}}


def step_bytes(cfg, tiles, seed):
    """Collective bytes of one tiled_batched_dynamic_step on this rank."""
    mesh = tile_mesh(tiles=tiles)
    rng = np.random.default_rng(seed)
    h, w = cfg.cam_h, cfg.cam_w
    frame = _tile(rng.integers(0, 256, (1, h, w), np.uint8), mesh)
    st = TrackerState(**{k: _tile(rng.uniform(0, 100, (1, h, w))
                                  .astype(np.float32), mesh)
                         for k in STATE}, frame_idx=0)
    tables = _tables(cfg)
    return devtime.collective_bytes(
        lambda: tiled_batched_dynamic_step(st, frame, tables, cfg, mesh))


def fuse(obs, mask, iters):
    """tiled_fuse_scans on this rank's landmark shard: (rot, trans,
    every rank's landmarks)."""
    mesh = fusion_mesh()
    obs_l, mask_l = shard_landmarks(mesh, torch.from_numpy(obs),
                                    torch.from_numpy(mask))
    rot, trans, lm = tiled_fuse_scans(obs_l, mask_l, mesh, iters=iters)
    lm = all_gather_cat(lm, 0, world_group(mesh))
    return rot.numpy(), trans.numpy(), lm.numpy()


def fail_on(rank):
    """Rank ``rank`` raises; the others wait for it in an all-reduce."""
    ctx = launch.initialize()
    if ctx.process_index == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    all_reduce(torch.ones(1), world_group(tile_mesh()))
    return ctx.process_index


def global_mesh(scan):
    mesh = launch.global_tile_mesh(scan=scan)
    return mesh_dims(mesh), mesh.mesh.numel()


def host_batch(data, scan, tiles, spec):
    """Each rank's block of ``data`` through local_scan_slice and
    shard_host_batch: its rows, its shape, the blocks' sum all-reduced
    over every rank, and the blocks gathered back."""
    mesh = launch.global_tile_mesh(scan=scan, tiles=tiles)
    rows = launch.local_scan_slice(mesh, data.shape[0])
    block = launch.shard_host_batch(mesh, data[rows], spec, device="cpu")
    total = all_reduce(block.double().sum(), world_group(mesh))
    if TILE_Y in spec:
        back = gather_image(block, mesh, scan=True)
    else:
        back = axis_gather(block, 0, mesh, SCAN)
    return ((rows.start, rows.stop), tuple(block.shape), float(total),
            back.numpy())


def scan_slice_error(scan, total):
    mesh = launch.global_tile_mesh(scan=scan)
    try:
        launch.local_scan_slice(mesh, total)
    except ValueError as e:
        return str(e)
    return None
