"""Image-tile-parallel pipeline stages (port of slc_tpu/parallel/tiled.py
on ``torch.distributed``).

Each rank owns an (H/ty, W/tx) tile of the camera image: every function
here takes this rank's tile and returns this rank's tile (slc_tpu's
``shard_map`` bodies, run SPMD). Decode and triangulation are pointwise
and need no halo, only global pixel coordinates for the back-projection.
The dynamic stripe tracker is a windowed stencil: it fetches an
``r + extend + 1`` px halo (:mod:`.halo`) and runs the raw stencils of
the single-device path (``ops.stripe``), then applies the reference's
interior masks in GLOBAL image coordinates, so the tiled result is the
single-device result: every pixel where the tiled and the image border
handling differ carries a zero delta (the 21-px window masks 10 px of
border). The CUDA stripe kernel cannot stand in on a tile: it masks in
the coordinates of its own input. So the tiled paths are plain torch, as
slc_tpu's are XLA ops.

The triangulation tables are passed whole (they are small per rank to
build, and slc_tpu passes them whole to ``shard_map``); each function
takes its tile's rows and columns of the per-pixel maps. ``shard_image``
cuts a rank's tile from a global array and ``gather_image`` puts the
tiles back together (``np.asarray`` of a sharded ``jax.Array``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import TrackerState
from slc_tpu_torch.ops.filters import box_blur_3x3
from slc_tpu_torch.ops.gray import decode_gray
from slc_tpu_torch.ops.phase import decode_phase, modulation
from slc_tpu_torch.ops.stripe import (box_sum_vertical_raw, select_delta_p,
                                      windowed_extrema_raw)
from slc_tpu_torch.ops.unwrap import gray_assisted_merge, heterodyne_unwrap
from slc_tpu_torch.parallel.halo import (all_reduce, axis_gather,
                                         global_offsets, halo_crop,
                                         halo_exchange)
from slc_tpu_torch.parallel.mesh import (SCAN, TILE_X, TILE_Y, axis_index,
                                         axis_size, mesh_device, world_group)
from slc_tpu_torch.pipeline import FrameResult


def _tile_slices(mesh, h: int, w: int) -> Tuple[slice, slice]:
    """This rank's rows and columns of a global (h, w) image."""
    ty, tx = axis_size(mesh, TILE_Y), axis_size(mesh, TILE_X)
    if h % ty or w % tx:
        raise ValueError(f"a {h}x{w} image does not split into {ty}x{tx} "
                         f"equal tiles")
    th, tw = h // ty, w // tx
    iy, ix = axis_index(mesh, TILE_Y), axis_index(mesh, TILE_X)
    return slice(iy * th, (iy + 1) * th), slice(ix * tw, (ix + 1) * tw)


def shard_image(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's tile of a global (..., H, W) array, contiguous, on the
    rank's device (where ``x`` is, on the 1x1x1 mesh)."""
    rows, cols = _tile_slices(mesh, x.shape[-2], x.shape[-1])
    tile = x[..., rows, cols].contiguous()
    dev = mesh_device(mesh)
    return tile if dev is None else tile.to(dev)


def gather_image(tile: torch.Tensor, mesh, scan: bool = False
                 ) -> torch.Tensor:
    """The global (..., H, W) array from every rank's (..., h, w) tile:
    an all-gather along ``TILE_Y``, then along ``TILE_X``; with ``scan``
    also along ``SCAN`` on dim 0 (arrays sharded over the scan axis)."""
    g = axis_gather(tile, tile.dim() - 2, mesh, TILE_Y)
    g = axis_gather(g, g.dim() - 1, mesh, TILE_X)
    if scan:
        g = axis_gather(g, 0, mesh, SCAN)
    return g


def _tile_tables(tables: TriangulationTables, mesh, h: int, w: int
                 ) -> TriangulationTables:
    """The tables with their per-pixel maps cut to this rank's tile of a
    global (h, w) image (the scalars are shared)."""
    rows, cols = _tile_slices(mesh, h, w)
    return dataclasses.replace(tables, c=tables.c[rows, cols],
                               d=tables.d[rows, cols])


def _tile_triangulate(proj_u: torch.Tensor, tables: TriangulationTables,
                      fov_min: float, fov_max: float, mesh,
                      valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile triangulation and back-projection in GLOBAL pixel
    coordinates (ops.triangulate on a tile; the u/v grids must be global,
    CCalculation.cpp:756-771). ``tables`` holds the tile's maps."""
    h, w = proj_u.shape
    row0, col0 = global_offsets(h, w, mesh)
    p = proj_u.float()
    denom = tables.c - tables.d * p
    z = (tables.b * p - tables.a) / denom
    hole = p == 0
    if valid is not None:
        hole = hole | ~valid
    z = torch.where(hole | (z < fov_min) | (z > fov_max),
                    torch.zeros_like(z), z)
    dev = proj_u.device
    u = torch.arange(col0, col0 + w, dtype=torch.float32,
                     device=dev)[None, :] - tables.cx
    v = torch.arange(row0, row0 + h, dtype=torch.float32,
                     device=dev)[:, None] - tables.cy
    return z * (u / tables.fx), z * (v / tables.fy), z


def tiled_absolute_decode(gray_images: torch.Tensor,
                          phase_images: torch.Tensor,
                          tables: TriangulationTables, cfg: SystemConfig,
                          mesh) -> FrameResult:
    """Tile-parallel frame-0 absolute decode and triangulation of this
    rank's (2B, h, w) Gray and (N, h, w) phase tiles. Pointwise: no
    halo."""
    g = decode_gray(gray_images, cfg.gray_bits, cfg.pro_w)
    ph = decode_phase(phase_images, cfg.phase_period)
    pu = gray_assisted_merge(g, ph, cfg.gray_period, cfg.phase_period)
    tb = _tile_tables(tables, mesh, cfg.cam_h, cfg.cam_w)
    x, y, z = _tile_triangulate(pu, tb, cfg.fov_min, cfg.fov_max, mesh)
    return FrameResult(x=x, y=y, z=z, proj_u=pu)


def tiled_heterodyne_decode(fringe_images: torch.Tensor,
                            tables: TriangulationTables, cfg: SystemConfig,
                            het: HeterodyneConfig, mesh,
                            min_modulation: Optional[float] = 2.0
                            ) -> FrameResult:
    """Tile-parallel multi-frequency heterodyne decode of this rank's
    (F*N, h, w) fringe tile (pipeline.decode_heterodyne_frame
    semantics). Pointwise: no halo."""
    n = het.phase_steps
    periods = het.periods(cfg.pro_w)
    stacks = [fringe_images[i * n:(i + 1) * n] for i in range(len(periods))]
    wrapped = torch.stack([decode_phase(s, float(p))
                           for s, p in zip(stacks, periods)])
    pu = heterodyne_unwrap(wrapped, periods, float(cfg.pro_w))
    valid = None
    if min_modulation is not None:
        valid = functools.reduce(torch.minimum,
                                 [modulation(s) for s in stacks]) \
            > min_modulation
        pu = torch.where(valid, pu, torch.zeros_like(pu))
    tb = _tile_tables(tables, mesh, cfg.cam_h, cfg.cam_w)
    x, y, z = _tile_triangulate(pu, tb, cfg.fov_min, cfg.fov_max, mesh,
                                valid)
    return FrameResult(x=x, y=y, z=z, proj_u=pu)


def _tile_stripe_regression(frame: torch.Tensor, window: int,
                            subpixel: bool, img_h: int, img_w: int,
                            extend: int, mesh
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stripe regression on one tile with a halo; returns the offset maps
    extended by ``extend`` (<= window//2) px of valid neighbour data on
    every side, interior-masked in global coordinates."""
    r = window // 2
    # +1: the sub-pixel parabola reads val_sum at offsets -(r+1) and +r,
    # one beyond the scan window (ops.stripe.windowed_extrema_raw).
    hw = r + extend + 1
    h, w = frame.shape
    row0, col0 = global_offsets(h, w, mesh)
    fe = halo_exchange(frame, hw, hw, mesh)
    vs = box_sum_vertical_raw(fe, window)
    # The reference's interior mask (CCalculation.cpp:801,817) in global
    # coordinates of the extended tile.
    dev = frame.device
    rows = torch.arange(row0 - hw, row0 + h + hw, device=dev)[:, None]
    cols = torch.arange(col0 - hw, col0 + w + hw, device=dev)[None, :]
    interior = ((rows >= r) & (rows < img_h - r)
                & (cols >= r) & (cols < img_w - r))
    zero = torch.zeros_like(vs)
    vs = torch.where(interior, vs, zero)
    sw, sb = windowed_extrema_raw(vs, window, subpixel)
    sw = torch.where(interior, sw, zero)
    sb = torch.where(interior, sb, zero)
    crop = hw - extend
    return halo_crop(sw, crop, crop), halo_crop(sb, crop, crop)


def tiled_stripe_regression(frame: torch.Tensor, cfg: SystemConfig, mesh,
                            subpixel: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-parallel CCalculation::StripRegression (CCalculation.cpp:
    789-891) of this rank's u8 frame tile, bit-identical to the
    single-device plain path."""
    return _tile_stripe_regression(frame, cfg.reco_window, subpixel,
                                   cfg.cam_h, cfg.cam_w, 0, mesh)


def _tile_step(proj_u, strip_w, strip_b, frame, tables, cfg, mesh,
               scale_gradient, subpixel, robust):
    """One open-loop step on a tile: (proj_u, strip_w, strip_b, x, y, z)."""
    sw1, sb1 = _tile_stripe_regression(frame, cfg.reco_window, subpixel,
                                       cfg.cam_h, cfg.cam_w, 1, mesh)
    pw1 = halo_exchange(strip_w, 1, 1, mesh)
    pb1 = halo_exchange(strip_b, 1, 1, mesh)
    dp1 = select_delta_p(pw1, pb1, sw1, sb1, robust=robust)
    dp = halo_crop(box_blur_3x3(dp1), 1, 1)          # CCalculation.cpp:650
    if scale_gradient:
        pue = halo_exchange(proj_u, 0, 1, mesh)
        g = 0.5 * (pue[:, 2:] - pue[:, :-2])
        dp = dp * g.clamp(0.2, 5.0)
    pu = proj_u + dp                                 # CCalculation.cpp:652
    tb = _tile_tables(tables, mesh, cfg.cam_h, cfg.cam_w)
    x, y, z = _tile_triangulate(pu, tb, cfg.fov_min, cfg.fov_max, mesh)
    return pu, halo_crop(sw1, 1, 1), halo_crop(sb1, 1, 1), x, y, z


def tiled_dynamic_step(state: TrackerState, frame: torch.Tensor,
                       tables: TriangulationTables, cfg: SystemConfig,
                       mesh, scale_gradient: bool = True,
                       subpixel: bool = True, robust: bool = True
                       ) -> Tuple[TrackerState, FrameResult]:
    """Tile-parallel open-loop dynamic step (CCalculation.cpp:221-316) on
    this rank's state and frame tiles, numerically the single-device
    plain step (kernels.dynamic_step.dynamic_step_open_ref): the stripe
    offsets are zero within window//2 px of the image border, so where
    the tiled 3x3 mean and gradient see zeros and the single-device ones
    reflect and wrap, the delta is zero. slc_tpu has no tiled locked
    step (tiled.py:187-225), nor has the port."""
    pu, sw, sb, x, y, z = _tile_step(
        state.proj_u, state.strip_w, state.strip_b, frame, tables, cfg,
        mesh, scale_gradient, subpixel, robust)
    return (TrackerState(proj_u=pu, strip_w=sw, strip_b=sb, z=z,
                         frame_idx=state.frame_idx + 1),
            FrameResult(x=x, y=y, z=z, proj_u=pu))


def tiled_batched_dynamic_step(states: TrackerState, frames: torch.Tensor,
                               tables: TriangulationTables,
                               cfg: SystemConfig, mesh,
                               scale_gradient: bool = True,
                               subpixel: bool = True, robust: bool = True):
    """Data parallelism over independent scans x image tiles: the full
    multi-device step. ``states`` and ``frames`` carry a leading scan
    axis of this rank's one scan, (1, h, w) (slc_tpu's P(SCAN, TILE_Y,
    TILE_X) shard). Returns (new_states, results, metrics), ``metrics``
    global over every rank: the valid-pixel fraction and mean depth, each
    a SUM all-reduce over the mesh's ranks divided by their number
    (``pmean`` over every axis)."""
    pu, sw, sb, x, y, z = _tile_step(
        states.proj_u[0], states.strip_w[0], states.strip_b[0], frames[0],
        tables, cfg, mesh, scale_gradient, subpixel, robust)
    local = torch.stack([(z > 0).float().mean(), z.mean()])
    n = 1 if mesh is None else mesh.mesh.numel()
    valid_frac, mean_z = all_reduce(local, world_group(mesh)) / n
    new = TrackerState(proj_u=pu[None], strip_w=sw[None], strip_b=sb[None],
                       z=z[None], frame_idx=states.frame_idx + 1)
    return (new,
            FrameResult(x=x[None], y=y[None], z=z[None], proj_u=pu[None]),
            {"valid_frac": valid_frac, "mean_z": mean_z})
