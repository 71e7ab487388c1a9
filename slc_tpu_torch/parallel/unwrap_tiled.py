"""Tile-parallel spatial unwrapping: distributed weighted-Poisson CG (port
of slc_tpu/parallel/unwrap_tiled.py on ``torch.distributed``).

The weighted-LS unwrap of ``ops.unwrap_spatial`` over an image-tile
mesh: the 5-point-stencil matvec fetches a 1-px halo per call; the CG
inner products are local partial sums all-reduced over the ranks of one
scan group's (ty, tx) plane, so the scalar CG coefficients are the same
on every rank and the iteration runs in lockstep. The CG loop reads its
all-reduced stopping norm back on the host each iteration, as the
single-device solver does. At the true image border the zero-filled halo
gives quality 0, "no edge", which is the single-device operator.

The multigrid preconditioner keeps its levels tile-sharded (per-tile
Galerkin aggregation, halo-exchange Jacobi smoothing) while the tile
dims are even and the global grid is above the coarsest size, then
all-gathers the rest and runs it REPLICATED through the single-device
``vcycle`` / ``_fcg2`` themselves; the level schedule is a function of
the global shape only, so it is the single-device solver's wherever the
switch happens. On a CUDA mesh the replicated levels of at least
``MG_KERNEL_MIN`` px run the hand-written multigrid kernels
(``kernels.mgsmooth``), as the single-device solver does; the sharded
levels are plain torch, as slc_tpu's are XLA ops.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

from slc_tpu_torch.ops.unwrap_spatial import (MG_COARSE_SWEEPS,
                                              MG_COARSEST, MG_KDEPTH, MG_NU,
                                              MG_OMEGA, MG_OVERCORR,
                                              _fcg2, build_mg_levels,
                                              lane_pair_sum, prolong2,
                                              restrict2, vcycle,
                                              wrap_to_half)
from slc_tpu_torch.parallel.halo import all_reduce, axis_gather, halo_exchange
from slc_tpu_torch.parallel.mesh import (TILE_X, TILE_Y, axis_index,
                                         axis_size, tile_group)


def _neighbor_stack(x_ext: torch.Tensor) -> tuple:
    """(up, down, left, right) neighbour views of a 1-px halo-extended
    tile, each cropped to the core shape."""
    return (x_ext[:-2, 1:-1], x_ext[2:, 1:-1],
            x_ext[1:-1, :-2], x_ext[1:-1, 2:])


def _gather_global(x: torch.Tensor, mesh) -> torch.Tensor:
    """The full (global_h, global_w) array on every rank of a scan group,
    from its (tile_h, tile_w) tiles: all-gathers along ``TILE_Y``, then
    ``TILE_X``, concatenated in axis order."""
    g = axis_gather(x, 0, mesh, TILE_Y)
    return axis_gather(g, 1, mesh, TILE_X)


def _coarsen_nbr(wn: tuple) -> tuple:
    """Per-tile exact Galerkin 2x2 aggregation of the neighbour-edge
    weight maps (ops.unwrap_spatial.coarsen_weights in the tiled (up,
    down, left, right) form; tile dims must be even so that no cell
    straddles a tile boundary). A tile's row-0 ``up`` weights already
    hold the neighbour tile's edge through the fine level's halo."""
    up, dn, lt, rt = wn
    return (lane_pair_sum(up[0::2, :]),
            lane_pair_sum(dn[1::2, :]),
            (lt[0::2, :] + lt[1::2, :])[:, 0::2],
            (rt[0::2, :] + rt[1::2, :])[:, 1::2])


def tiled_unwrap_spatial(psi: torch.Tensor, period: float, mesh,
                         quality: Optional[torch.Tensor] = None,
                         max_iters: int = 300, tol: float = 3e-4,
                         anchor: Optional[torch.Tensor] = None,
                         return_info: bool = False, mg: bool = True):
    """Distributed ``ops.unwrap_spatial.unwrap_spatial`` on this rank's
    (h, w) tiles of psi, quality and anchor: the same operator, CG and
    default ``tol`` (3e-4), in lockstep across tiles, the multigrid
    preconditioner included (see the module note). Returns this rank's
    tile of P; with ``return_info`` also the diagnostics dict:
    ``cg_iters`` (int) and ``rel_residual`` the same on every rank, the
    residue, suspect and anchor-disagreement counts all-reduced over the
    tiles, the ``suspect`` and ``anchor_disagreement`` masks this rank's
    tiles.

    Tile dims should be EVEN at the finest level: odd tiles leave no
    level sharded, so every V-cycle all-gathers the full-resolution
    residual (correct, but it defeats the sharding; hence the
    warning)."""
    th0, tw0 = psi.shape
    if mg and (th0 % 2 or tw0 % 2):
        warnings.warn(
            f"tiled_unwrap_spatial: tile dims ({th0}x{tw0}) are odd at the "
            f"finest level; the multigrid hierarchy cannot shard and every "
            f"V-cycle will all_gather the full-resolution residual. Use "
            f"even tile dims for a sharded hierarchy.", stacklevel=2)
    group = tile_group(mesh)
    psi_t = psi.float()
    q_t = (torch.ones_like(psi_t) if quality is None else quality.float())
    p0 = psi_t if anchor is None else anchor.float()

    def psum(x):
        return all_reduce(x, group)

    def dot(a, c):
        return psum(torch.sum(a * c))

    q_t = q_t / torch.clamp(all_reduce(q_t.max(), group,
                                       dist.ReduceOp.MAX), min=1e-20)
    q_ext = halo_exchange(q_t, 1, 1, mesh)
    psi_ext = halo_exchange(psi_t, 1, 1, mesh)
    w_nbr = tuple(torch.minimum(q_t, qn) for qn in _neighbor_stack(q_ext))
    d_nbr = tuple(wrap_to_half(psi_t - pn, period)
                  for pn in _neighbor_stack(psi_ext))

    def mk_matvec(wn):
        def mv(p):
            p_ext = halo_exchange(p, 1, 1, mesh)
            out = torch.zeros_like(p)
            for w_, pn in zip(wn, _neighbor_stack(p_ext)):
                out = out + w_ * (p - pn)
            return out
        return mv

    matvec = mk_matvec(w_nbr)
    b = torch.zeros_like(psi_t)
    diag = torch.zeros_like(psi_t)
    for w_, d_ in zip(w_nbr, d_nbr):
        b = b + w_ * d_
        diag = diag + w_
    dinv = 1.0 / torch.clamp(diag, min=1e-8)

    iy, ix = axis_index(mesh, TILE_Y), axis_index(mesh, TILE_X)

    def own(e_g, like):
        """This rank's tile of a replicated global array."""
        h, w = like.shape
        return e_g[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w]

    if mg:
        # Sharded levels (module note); nu, omega and the coarsest size
        # of ops.unwrap_spatial.vcycle.
        gh, gw = th0 * axis_size(mesh, TILE_Y), tw0 * axis_size(mesh, TILE_X)
        shard_levels = []
        cw, cth, ctw = w_nbr, th0, tw0
        while min(gh, gw) > MG_COARSEST and cth % 2 == 0 and ctw % 2 == 0:
            dg = cw[0] + cw[1] + cw[2] + cw[3]
            shard_levels.append((cw, 1.0 / torch.clamp(dg, min=1e-8)))
            cw = _coarsen_nbr(cw)
            cth //= 2
            ctw //= 2
            gh //= 2
            gw //= 2
        # The replicated rest: the switch level's weights in the
        # single-device (wy, wx) form (contiguous, as the multigrid
        # kernels take them), and ops' own hierarchy below.
        wy_g = _gather_global(cw[0], mesh)[1:, :].contiguous()
        wx_g = _gather_global(cw[2], mesh)[:, 1:].contiguous()
        sub_levels = build_mg_levels(wy_g, wx_g, gh, gw,
                                     coarsest=MG_COARSEST)
        n_total = len(shard_levels) + len(sub_levels)

        # The K-cycle schedule in GLOBAL level indices: the correction at
        # level li+1 is two flexible-CG steps iff li < KDEPTH and li+1 is
        # not the coarsest, the single-device vcycle's rule (its kdepth at
        # level li is KDEPTH - li).
        def vt(r, li):
            if li >= len(shard_levels):
                return own(vcycle(_gather_global(r, mesh), sub_levels,
                                  MG_NU, MG_OMEGA, MG_COARSE_SWEEPS,
                                  kdepth=max(0, MG_KDEPTH - li)), r)
            wn, dinv_l = shard_levels[li]
            mv = mk_matvec(wn)
            e = MG_OMEGA * dinv_l * r
            for _ in range(MG_NU - 1):
                e = e + MG_OMEGA * dinv_l * (r - mv(e))
            rc = restrict2(r - mv(e))
            if li < MG_KDEPTH and li + 1 < n_total - 1:
                e = e + prolong2(fcg2_t(rc, li + 1), *r.shape)
            else:
                e = e + MG_OVERCORR * prolong2(vt(rc, li + 1), *r.shape)
            for _ in range(MG_NU):
                e = e + MG_OMEGA * dinv_l * (r - mv(e))
            return e

        def fcg2_t(bb, lj):
            # ops.unwrap_spatial._fcg2 with all-reduced dots.
            if lj >= len(shard_levels):
                return own(_fcg2(_gather_global(bb, mesh), sub_levels,
                                 MG_NU, MG_OMEGA, MG_COARSE_SWEEPS,
                                 max(0, MG_KDEPTH - lj)), bb)
            mv = mk_matvec(shard_levels[lj][0])
            z0 = vt(bb, lj)
            v0 = mv(z0)
            rho0 = torch.clamp(dot(z0, v0), min=1e-30)
            alpha0 = dot(z0, bb) / rho0
            x1 = alpha0 * z0
            r1 = bb - alpha0 * v0
            z1 = vt(r1, lj)
            v1 = mv(z1)
            gam = dot(z1, v0) / rho0
            rho1 = torch.clamp(dot(z1, v1) - gam * gam * rho0, min=1e-30)
            t = dot(z1, r1) / rho1
            return x1 + t * (z1 - gam * z0)

        def precond(r):
            return vt(r, 0)
    else:
        def precond(r):
            return dinv * r

    p = p0
    r = b - matvec(p0)
    z = precond(r)
    d = z
    b_norm = torch.sqrt(dot(b, b)) + 1e-20
    iters = 0
    # The stopping test reads one all-reduced bool back per iteration:
    # the same on every rank, so the loop stays in lockstep.
    while iters < max_iters and bool(torch.sqrt(dot(r, r)) > tol * b_norm):
        ad = matvec(d)
        rz = dot(r, z)
        alpha = rz / torch.clamp(dot(d, ad), min=1e-20)
        p = p + alpha * d
        r_new = r - alpha * ad
        z_new = precond(r_new)
        # Flexible (Polak-Ribiere+) beta, the single-device solver's.
        beta = torch.clamp(dot(z_new, r_new - r)
                           / torch.clamp(rz, min=1e-20), min=0.0)
        r, z, d = r_new, z_new, z_new + beta * d
        iters += 1

    wsum = torch.clamp(psum(q_t.sum()), min=1e-20)
    shift = psum(torch.sum(q_t * (p - p0))) / wsum
    p = p - shift + torch.round(shift / period) * period
    k = torch.round((p - psi_t) / period)
    out = psi_t + k * period
    if not return_info:
        return out

    # Plaquette residues anchored at core pixels, from the right and
    # bottom halo; the global last row and column have no plaquette, so
    # they are masked on the edge tiles (their halo is zero-filled).
    c = psi_ext[1:-1, 1:-1]
    rt = psi_ext[1:-1, 2:]
    dn = psi_ext[2:, 1:-1]
    dg = psi_ext[2:, 2:]
    loop = (wrap_to_half(rt - c, period) + wrap_to_half(dg - rt, period)
            - wrap_to_half(dg - dn, period) - wrap_to_half(dn - c, period))
    charge = torch.round(loop / period).to(torch.int32).abs()
    h, w = charge.shape
    valid = torch.ones_like(charge, dtype=torch.bool)
    if iy == axis_size(mesh, TILE_Y) - 1:
        valid[h - 1, :] = False
    if ix == axis_size(mesh, TILE_X) - 1:
        valid[:, w - 1] = False
    residue_count = psum(torch.where(valid, charge,
                                     torch.zeros_like(charge)).sum())

    # Suspect (cut high-quality) edges; the zero-filled halo quality makes
    # border edges weight 0, so they never flag.
    out_ext = halo_exchange(out, 1, 1, mesh)
    sus = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
    for w_, d_, pn in zip(w_nbr, d_nbr, _neighbor_stack(out_ext)):
        sus = sus | ((((out - pn) - d_).abs() > period / 2.0)
                     & (w_ > 0.5))
    dis = (out - p0).abs() > period / 2.0
    info = {
        "cg_iters": iters,
        "rel_residual": torch.sqrt(dot(r, r)) / b_norm,
        "residue_count": residue_count,
        "suspect": sus,
        "suspect_count": psum(sus.sum()),
        "anchor_disagreement": dis,
        "anchor_disagreement_count": psum(dis.sum()),
    }
    return out, info
