"""Plain PyTorch reference of the spatial decode: one 4-step fringe stack
unwrapped by weighted least squares, anchored on a previous map,
triangulated and filtered.

A frozen copy of the port's plain path (``slc_tpu_torch/pipeline.
decode_spatial_frame`` on a CPU tensor: ``ops/phase.py``,
``ops/unwrap_spatial.py``, ``ops/triangulate.py``, ``ops/filters.
bilateral_filter``), which follows ``slc_tpu/ops/unwrap_spatial.py:
332-442``. Every floating-point operation runs in ``dt``: float32 is the
configuration's stated precision, bfloat16 the control's. It imports
nothing of the program and no kernel; the wrapped phase, the modulation,
the tables and the triangulation come from ``plain``.

The unwrap is the weighted least-squares problem of Ghiglia and Romero
(JOSA A 11(1):107-117, 1994),

    minimize  sum over edges e = (i, j) of  w_e (P_i - P_j - d_e)^2,

with d_e the wrapped difference of the measured coordinate along the
edge, in [-T/2, T/2), and w_e = min(q_i, q_j) of the modulation
normalised by its largest value. Its normal equations are a weighted
Poisson system (5-point stencil), solved by conjugate gradients with a
K-cycle multigrid preconditioner (Notay): exact-Galerkin 2x2 aggregation
down to 32 px, two damped-Jacobi sweeps (omega 0.9) each way, two steps
of flexible CG at the first two coarse levels, plain V recursion with an
over-correction of 2 below, 32 Jacobi sweeps at the coarsest. Departures
from the published method, each the port's:

- the stopping rule: CG stops at a relative residual norm of ``tol``
  (3e-4) or after ``max_iters``, not at convergence; the congruence snap
  below absorbs what is left, and the tier-1 tests record how many
  fringe orders that changes against a converged solve;
- CG starts from the anchor (the previous map, whose holes read 0), and
  the Laplacian's constant nullspace is fixed by the anchor: the
  quality-weighted mean of (P - anchor) is removed, less its whole
  periods, so the gauge moves only by whole periods;
- the solution is snapped to congruence with the measurement,
  P = psi + T round((P_ls - psi) / T), so every pixel keeps its measured
  fraction of a period;
- the flexible (Polak-Ribiere, clamped at 0) beta, for the K-cycle's
  mildly nonlinear preconditioner.

Pixels whose modulation is not above ``min_modulation`` are holes (P and
z 0); z is filtered by the hole-aware bilateral filter of
``depthMapUtils.cpp:179`` (d = 3, sigmaColor 10, sigmaSpace 25), holes
and out-of-image neighbours counted as missing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slcbench.reference.plain import (Tables, decode_phase, modulation,
                                      triangulate_depth)

#: The multigrid preconditioner's settings (the port's and slc_tpu's).
MG_NU = 2
MG_OMEGA = 0.9
MG_COARSE_SWEEPS = 32
MG_COARSEST = 32
MG_KDEPTH = 2
MG_OVERCORR = 2.0


# --- the least-squares system -----------------------------------------

def wrap_to_half(d: torch.Tensor, period: float) -> torch.Tensor:
    return d - period * torch.floor(d / period + 0.5)


def wrapped_gradients(psi: torch.Tensor, period: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward wrapped differences, dy (H-1, W) and dx (H, W-1)."""
    return (wrap_to_half(psi[1:, :] - psi[:-1, :], period),
            wrap_to_half(psi[:, 1:] - psi[:, :-1], period))


def edge_weights(quality: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = quality / torch.clamp(quality.max(), min=1e-20)
    return (torch.minimum(q[1:, :], q[:-1, :]),
            torch.minimum(q[:, 1:], q[:, :-1]))


def edge_scatter(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Sum over each pixel's edges, oriented away from it."""
    return ((F.pad(dy, (0, 0, 1, 0)) - F.pad(dy, (0, 0, 0, 1)))
            + F.pad(dx, (1, 0))) - F.pad(dx, (0, 1))


def matvec(p: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor
           ) -> torch.Tensor:
    """The weighted graph Laplacian: sum_j w_ij (p_i - p_j)."""
    return edge_scatter(wy * (p[1:, :] - p[:-1, :]),
                        wx * (p[:, 1:] - p[:, :-1]))


def diagonal(wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    d = (((F.pad(wy, (0, 0, 1, 0)) + F.pad(wy, (0, 0, 0, 1)))
          + F.pad(wx, (1, 0))) + F.pad(wx, (0, 1)))
    return torch.clamp(d, min=1e-8)


# --- the multigrid preconditioner -------------------------------------

def coarsen_weights(wy, wx, h: int, w: int):
    """Exact Galerkin weights of 2x2 aggregation: each coarse edge sums
    the fine edges that cross its cut."""
    cut_y = wy[1::2, :]
    if w % 2:
        cut_y = F.pad(cut_y, (0, 1))
    wy_c = cut_y[:, 0::2] + cut_y[:, 1::2]
    cut_x = wx[:, 1::2]
    if h % 2:
        cut_x = F.pad(cut_x, (0, 0, 0, 1))
    return wy_c, cut_x[0::2, :] + cut_x[1::2, :]


def restrict2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return (x[0::2, 0::2] + x[1::2, 0::2]
            + x[0::2, 1::2] + x[1::2, 1::2])


def prolong2(e: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return e.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def build_levels(wy, wx, h: int, w: int) -> list:
    """Fine to coarse (wy, wx, 1 / diagonal, (h, w)) down to 32 px."""
    levels = [(wy, wx, 1.0 / diagonal(wy, wx), (h, w))]
    while min(levels[-1][3]) > MG_COARSEST:
        lwy, lwx, _, (lh, lw) = levels[-1]
        cwy, cwx = coarsen_weights(lwy, lwx, lh, lw)
        levels.append((cwy, cwx, 1.0 / diagonal(cwy, cwx),
                       (-(-lh // 2), -(-lw // 2))))
    return levels


def cycle(r: torch.Tensor, levels: list, kdepth: int = MG_KDEPTH
          ) -> torch.Tensor:
    """One K-cycle approximating A^-1 r."""
    wy, wx, dinv, (h, w) = levels[0]
    omega = MG_OMEGA
    if len(levels) == 1:
        e = omega * dinv * r
        for _ in range(MG_COARSE_SWEEPS - 1):
            e = e + omega * dinv * (r - matvec(e, wy, wx))
        return e
    e = omega * dinv * r
    for _ in range(MG_NU - 1):
        e = e + omega * dinv * (r - matvec(e, wy, wx))
    rc = restrict2(r - matvec(e, wy, wx))
    if kdepth > 0 and len(levels) > 2:
        e = e + prolong2(fcg2(rc, levels[1:], kdepth - 1), h, w)
    else:
        e = e + MG_OVERCORR * prolong2(cycle(rc, levels[1:], 0), h, w)
    for _ in range(MG_NU):
        e = e + omega * dinv * (r - matvec(e, wy, wx))
    return e


def fcg2(b: torch.Tensor, levels: list, kdepth: int) -> torch.Tensor:
    """Two steps of flexible CG on a coarse system from 0."""
    wy, wx, _, _ = levels[0]
    z0 = cycle(b, levels, kdepth)
    v0 = matvec(z0, wy, wx)
    rho0 = torch.clamp(torch.sum(z0 * v0), min=1e-30)
    alpha0 = torch.sum(z0 * b) / rho0
    x1 = alpha0 * z0
    r1 = b - alpha0 * v0
    z1 = cycle(r1, levels, kdepth)
    v1 = matvec(z1, wy, wx)
    gam = torch.sum(z1 * v0) / rho0
    rho1 = torch.clamp(torch.sum(z1 * v1) - gam * gam * rho0, min=1e-30)
    t = torch.sum(z1 * r1) / rho1
    return x1 + t * (z1 - gam * z0)


# --- the unwrap and the decode ----------------------------------------

def unwrap(psi: torch.Tensor, period: float, quality: torch.Tensor,
           anchor: Optional[torch.Tensor], max_iters: int, tol: float,
           mg: bool = True) -> Tuple[torch.Tensor, int]:
    """The anchored weighted-LS unwrap of the wrapped coordinate ``psi``;
    returns (P congruent with psi at every pixel, CG iterations)."""
    dy, dx = wrapped_gradients(psi, period)
    wy, wx = edge_weights(quality)
    b = edge_scatter(wy * dy, wx * dx)
    if mg:
        levels = build_levels(wy, wx, psi.shape[0], psi.shape[1])
        precond = lambda r: cycle(r, levels)           # noqa: E731
    else:
        dinv = 1.0 / diagonal(wy, wx)
        precond = lambda r: dinv * r                   # noqa: E731
    anc = anchor.to(psi.dtype) if anchor is not None else psi
    p = anc
    r = b - matvec(p, wy, wx)
    z = precond(r)
    d = z
    b_norm = torch.sqrt(torch.sum(b * b)) + 1e-20
    iters = 0
    while iters < max_iters and bool(torch.sqrt(torch.sum(r * r))
                                     > tol * b_norm):
        ad = matvec(d, wy, wx)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(d * ad), min=1e-20)
        p = p + alpha * d
        r_new = r - alpha * ad
        z_new = precond(r_new)
        beta = torch.clamp(torch.sum(z_new * (r_new - r))
                           / torch.clamp(rz, min=1e-20), min=0.0)
        r, z, d = r_new, z_new, z_new + beta * d
        iters += 1
    wsum = torch.clamp(quality.sum(), min=1e-20)
    shift = torch.sum(quality * (p - anc)) / wsum
    p = p - shift + torch.round(shift / period) * period
    k = torch.round((p - psi) / period)
    return psi + k * period, iters


def bilateral(z: torch.Tensor, radius: int = 1, sigma_color: float = 10.0,
              sigma_space: float = 25.0) -> torch.Tensor:
    """Hole-aware bilateral filter over a (2r+1)^2 stencil: z == 0 and
    out-of-image neighbours get no weight, holes stay 0. The exponent
    scales are rounded to float32."""
    r = radius
    h, w = z.shape
    inv2sc = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    inv2ss = float(np.float32(-0.5 / (sigma_space * sigma_space)))
    valid = z != 0
    zp = F.pad(z, (r, r, r, r))
    okp = F.pad(valid.to(z.dtype), (r, r, r, r))
    num = torch.zeros_like(z)
    den = torch.zeros_like(z)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            v = zp[r + dy:r + dy + h, r + dx:r + dx + w]
            space = float(np.float32(dy * dy + dx * dx) * np.float32(inv2ss))
            wt = torch.exp((v - z) * (v - z) * inv2sc + space)
            wt = wt * okp[r + dy:r + dy + h, r + dx:r + dx + w]
            num = num + wt * v
            den = den + wt
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(valid, out, torch.zeros_like(out))


def decode_spatial(images: torch.Tensor, t: Tables, sysc: dict,
                   spatial: dict, anchor: Optional[torch.Tensor] = None,
                   dt=torch.float32) -> Tuple[torch.Tensor, torch.Tensor,
                                              int]:
    """The spatial decode of an (N, H, W) u8 fringe stack with the
    configuration's ``spatial`` settings; returns (z, P, CG
    iterations). It runs no matrix product, and lets none run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    period = float(spatial["period"])
    psi = decode_phase(images, period, dt)
    quality = modulation(images, dt)
    pu, iters = unwrap(psi, period, quality, anchor,
                       int(spatial["unwrap_iters"]), float(spatial["tol"]),
                       bool(spatial["mg"]))
    valid = quality > float(spatial["min_modulation"])
    pu = torch.where(valid, pu, torch.zeros_like(pu))
    z = triangulate_depth(pu, t, (sysc["fov_min"], sysc["fov_max"]), valid)
    if spatial["filter_depth"]:
        f = spatial["bilateral"]
        z = bilateral(z, int(f["radius"]), float(f["sigma_color"]),
                      float(f["sigma_space"]))
    return z, pu, iters
