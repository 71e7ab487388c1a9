"""Quality-guided spatial phase unwrapping (PyTorch port of
slc_tpu/ops/unwrap_spatial.py).

Absent from the reference, which only does Gray-assisted temporal unwrap
(CCalculation.cpp:561-587). The unwrap is a weighted least-squares
problem (Ghiglia-Romero style):

    minimize  sum_edges w_e (P_i - P_j - d_e)^2

where d_e is the *wrapped* phase difference along the edge (in [-T/2,
T/2)) and the edge weight w_e = min(q_i, q_j) is the quality gate: low
quality pixels and phase discontinuities get near-zero weight. The
normal equations are a weighted Poisson system, solved by conjugate
gradient preconditioned with a K-cycle multigrid over exact-Galerkin
2x2 aggregation; the matvec is a 5-point stencil. The LS solution is
then snapped to congruence with the measured wrapped phase
(P = psi + T*round((P_ls - psi)/T)).

Differences from slc_tpu, by design:

- The CG loop is a Python loop that reads the residual norm on the host
  once per iteration (slc_tpu runs ``lax.while_loop`` on the device).
- The transfer operators take the strided form on every device
  (slc_tpu's CPU branch of ``_tpu_layout``; its TPU branch differs only
  in float association).
- Levels with ``min(h, w) >= MG_KERNEL_MIN`` run their descent and
  ascent through ``kernels.mgsmooth`` (the hand-written CUDA kernels on a
  CUDA tensor, the same ops as below on the CPU), slc_tpu's own level
  rule (unwrap_spatial.py:240).
- torch sums in another order than XLA, so the CG iteration count may
  differ from slc_tpu's by one; the congruence snap gives the same fringe
  orders.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from slc_tpu_torch import metrics


def wrap_to_half(d: torch.Tensor, period: float) -> torch.Tensor:
    """Wrap values into [-T/2, T/2)."""
    return d - period * torch.floor(d / period + 0.5)


def wrapped_gradients(psi: torch.Tensor, period: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward wrapped differences (dy (H-1, W), dx (H, W-1))."""
    dy = wrap_to_half(psi[1:, :] - psi[:-1, :], period)
    dx = wrap_to_half(psi[:, 1:] - psi[:, :-1], period)
    return dy, dx


def edge_weights(quality: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quality-guided edge weights w_e = min(q_i, q_j), quality
    normalized to [0, 1] by its max."""
    q = quality / torch.clamp(quality.max(), min=1e-20)
    wy = torch.minimum(q[1:, :], q[:-1, :])
    wx = torch.minimum(q[:, 1:], q[:, :-1])
    return wy, wx


def _edge_scatter(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """out_i = sum over incident edges, oriented away from i, in the
    association ((dy_up - dy_dn) + dx_lt) - dx_rt of slc_tpu."""
    return ((F.pad(dy, (0, 0, 1, 0)) - F.pad(dy, (0, 0, 0, 1)))
            + F.pad(dx, (1, 0))) - F.pad(dx, (0, 1))


def _matvec(p: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor
            ) -> torch.Tensor:
    """(A p)_i = sum_j w_ij (p_i - p_j) over the 4-neighbourhood: the
    weighted graph Laplacian as a 5-point stencil."""
    return _edge_scatter(wy * (p[1:, :] - p[:-1, :]),
                         wx * (p[:, 1:] - p[:, :-1]))


def _rhs(dy, dx, wy, wx) -> torch.Tensor:
    """b_i = sum_j w_ij d_ij with d oriented away from i."""
    return _edge_scatter(wy * dy, wx * dx)


def _diag(wy, wx) -> torch.Tensor:
    d = (((F.pad(wy, (0, 0, 1, 0)) + F.pad(wy, (0, 0, 0, 1)))
          + F.pad(wx, (1, 0))) + F.pad(wx, (0, 1)))
    return torch.clamp(d, min=1e-8)


# Multigrid-preconditioner hyperparameters, slc_tpu's
# (unwrap_spatial.py:93-123, where the tuning is recorded).
MG_NU = 2
MG_OMEGA = 0.9
MG_COARSE_SWEEPS = 32
MG_COARSEST = 32
MG_KDEPTH = 2
MG_OVERCORR = 2.0
#: Levels at least this large on both sides run through kernels.mgsmooth.
MG_KERNEL_MIN = 256


def lane_pair_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum of adjacent column pairs: (n, 2m) -> (n, m)."""
    return a[:, 0::2] + a[:, 1::2]


def coarsen_weights(wy: torch.Tensor, wx: torch.Tensor, h: int, w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Galerkin coarse operator for 2x2 piecewise-constant
    aggregation: the coarse edge weight is the sum of the fine edge
    weights crossing the cell cut. The vertical cut between coarse rows
    I, I+1 is fine edge row 2I+1; columns pair up within the cell."""
    cut_y = wy[1::2, :]                          # (hc-1, w)
    if w % 2:
        cut_y = F.pad(cut_y, (0, 1))
    wy_c = lane_pair_sum(cut_y)
    cut_x = wx[:, 1::2]                          # (h, wc-1)
    if h % 2:
        cut_x = F.pad(cut_x, (0, 0, 0, 1))
    wx_c = cut_x[0::2, :] + cut_x[1::2, :]
    return wy_c, wx_c


def restrict2(x: torch.Tensor) -> torch.Tensor:
    """P^T: 2x2 cell sums (zero-padded to even)."""
    h, w = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return (x[0::2, 0::2] + x[1::2, 0::2]
            + x[0::2, 1::2] + x[1::2, 1::2])


def prolong2(e: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """P: repeat each coarse value to its 2x2 cell."""
    return e.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def build_mg_levels(wy: torch.Tensor, wx: torch.Tensor, h: int, w: int,
                    coarsest: int = MG_COARSEST) -> list:
    """Fine-to-coarse hierarchy of (wy, wx, dinv, (h, w)) by the exact
    Galerkin aggregation of :func:`coarsen_weights`."""
    levels = [(wy, wx, 1.0 / _diag(wy, wx), (h, w))]
    while min(levels[-1][3]) > coarsest:
        lwy, lwx, _, (lh, lw) = levels[-1]
        cwy, cwx = coarsen_weights(lwy, lwx, lh, lw)
        ch, cw = -(-lh // 2), -(-lw // 2)
        levels.append((cwy, cwx, 1.0 / _diag(cwy, cwx), (ch, cw)))
    return levels


def vcycle(r: torch.Tensor, levels: list, nu: int = MG_NU,
           omega: float = MG_OMEGA,
           coarse_sweeps: int = MG_COARSE_SWEEPS,
           kdepth: int = MG_KDEPTH) -> torch.Tensor:
    """One multigrid cycle approximating A^{-1} r (slc_tpu's
    unwrap_spatial.py:201-263): damped-Jacobi pre-smooth, exact-Galerkin
    coarse-grid correction, damped-Jacobi post-smooth. The correction at
    the first ``kdepth`` coarse levels is a K-cycle (:func:`_fcg2`);
    below that, plain V recursion with the over-correction factor."""
    wy, wx, dinv, (h, w) = levels[0]
    if len(levels) == 1:
        e = omega * dinv * r              # first Jacobi sweep from e=0
        for _ in range(coarse_sweeps - 1):
            e = e + omega * dinv * (r - _matvec(e, wy, wx))
        return e
    fused = nu == 2 and min(h, w) >= MG_KERNEL_MIN
    if fused:
        from slc_tpu_torch.kernels import mgsmooth
        e, res = mgsmooth.mg_down(r, wy, wx, dinv, omega)
        rc = restrict2(res)
    else:
        e = omega * dinv * r              # first Jacobi sweep from e=0
        for _ in range(nu - 1):
            e = e + omega * dinv * (r - _matvec(e, wy, wx))
        rc = restrict2(r - _matvec(e, wy, wx))
    if kdepth > 0 and len(levels) > 2:
        ec = _fcg2(rc, levels[1:], nu, omega, coarse_sweeps, kdepth - 1)
        e = e + prolong2(ec, h, w)
    else:
        ec = vcycle(rc, levels[1:], nu, omega, coarse_sweeps, 0)
        e = e + MG_OVERCORR * prolong2(ec, h, w)
    if fused:
        return mgsmooth.mg_up(e, r, wy, wx, dinv, omega)
    for _ in range(nu):
        e = e + omega * dinv * (r - _matvec(e, wy, wx))
    return e


def _fcg2(b: torch.Tensor, levels: list, nu: int, omega: float,
          coarse_sweeps: int, kdepth: int) -> torch.Tensor:
    """Two steps of flexible CG on the coarse system A_c x = b from
    x = 0, preconditioned by this level's own cycle: the K-cycle coarse
    solve (Notay)."""
    wy, wx, _, _ = levels[0]
    z0 = vcycle(b, levels, nu, omega, coarse_sweeps, kdepth)
    v0 = _matvec(z0, wy, wx)
    rho0 = torch.clamp(torch.sum(z0 * v0), min=1e-30)
    alpha0 = torch.sum(z0 * b) / rho0
    x1 = alpha0 * z0
    r1 = b - alpha0 * v0
    z1 = vcycle(r1, levels, nu, omega, coarse_sweeps, kdepth)
    v1 = _matvec(z1, wy, wx)
    gam = torch.sum(z1 * v0) / rho0
    rho1 = torch.clamp(torch.sum(z1 * v1) - gam * gam * rho0, min=1e-30)
    t = torch.sum(z1 * r1) / rho1
    return x1 + t * (z1 - gam * z0)


def residues(psi: torch.Tensor, period: float) -> torch.Tensor:
    """Phase residues: the loop integral of wrapped gradients around
    each 2x2 plaquette, in fringe orders; an (H-1, W-1) int32 charge
    map."""
    dy, dx = wrapped_gradients(psi, period)
    loop = dx[:-1, :] + dy[:, 1:] - dx[1:, :] - dy[:, :-1]
    return torch.round(loop / period).to(torch.int32)


def suspect_edges(p: torch.Tensor, psi: torch.Tensor, period: float,
                  quality: Optional[torch.Tensor] = None,
                  weight_floor: float = 0.5) -> torch.Tensor:
    """(H, W) bool: pixels with an incident edge of quality weight above
    ``weight_floor`` that the solution cut,
    |(P_i - P_j) - wrapped(psi_i - psi_j)| > T/2."""
    half = period / 2.0
    dy, dx = wrapped_gradients(psi, period)
    if quality is None:
        wy, wx = torch.ones_like(dy), torch.ones_like(dx)
    else:
        wy, wx = edge_weights(quality.float())
    cut_y = ((p[1:, :] - p[:-1, :]) - dy).abs() > half
    cut_y &= wy > weight_floor
    cut_x = ((p[:, 1:] - p[:, :-1]) - dx).abs() > half
    cut_x &= wx > weight_floor
    out = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    out[1:, :] |= cut_y
    out[:-1, :] |= cut_y
    out[:, 1:] |= cut_x
    out[:, :-1] |= cut_x
    return out


def _above(r: torch.Tensor, bound: torch.Tensor) -> bool:
    """Whether the residual norm is above ``bound``, read back to the
    host: the span ``unwrap.wait``."""
    with metrics.span("unwrap.wait"):
        return bool(torch.sqrt(torch.sum(r * r)) > bound)


def unwrap_spatial(psi: torch.Tensor, period: float,
                   quality: Optional[torch.Tensor] = None,
                   max_iters: int = 300, tol: float = 3e-4,
                   anchor: Optional[torch.Tensor] = None,
                   return_info: bool = False, mg: bool = True):
    """Weighted-LS spatial unwrap of the wrapped coordinate ``psi`` in
    [0, T) (slc_tpu/ops/unwrap_spatial.py:332-442).

    ``quality`` is the (H, W) quality map (None = uniform); ``tol`` the
    relative residual-norm stopping threshold; ``anchor`` an optional
    (H, W) absolute estimate whose weighted mean fixes the Laplacian's
    constant nullspace (default: psi itself). Returns the (H, W) float32
    absolute coordinate, congruent with psi modulo T at every pixel;
    with ``return_info`` also a dict of ``cg_iters`` (int),
    ``rel_residual``, ``residue_count``, ``suspect``, ``suspect_count``,
    ``anchor_disagreement`` and ``anchor_disagreement_count``.

    Under a profiler it counts ``unwrap.calls`` (1 a call) and
    ``unwrap.cg_iters`` (its CG iterations), and spans
    ``unwrap.levels`` (the multigrid hierarchy's enqueue) and
    ``unwrap.wait`` (each residual read-back, a wait on the device)."""
    psi = psi.float()
    if quality is None:
        quality = torch.ones_like(psi)
    quality = quality.float()
    dy, dx = wrapped_gradients(psi, period)
    wy, wx = edge_weights(quality)
    b = _rhs(dy, dx, wy, wx)
    if mg:
        with metrics.span("unwrap.levels"):
            levels = build_mg_levels(wy, wx, psi.shape[0], psi.shape[1])
        precond = lambda r: vcycle(r, levels)       # noqa: E731
    else:
        dinv = 1.0 / _diag(wy, wx)
        precond = lambda r: dinv * r                # noqa: E731

    anc = anchor.float() if anchor is not None else psi
    p = anc
    r = b - _matvec(p, wy, wx)
    z = precond(r)
    d = z
    b_norm = torch.sqrt(torch.sum(b * b)) + 1e-20
    iters = 0
    # The stopping test reads one bool back per iteration.
    while iters < max_iters and _above(r, tol * b_norm):
        ad = _matvec(d, wy, wx)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(d * ad), min=1e-20)
        p = p + alpha * d
        r_new = r - alpha * ad
        z_new = precond(r_new)
        # Flexible (Polak-Ribiere+) beta for the K-cycle's mildly
        # nonlinear preconditioner.
        beta = torch.clamp(torch.sum(z_new * (r_new - r))
                           / torch.clamp(rz, min=1e-20), min=0.0)
        r, z, d = r_new, z_new, z_new + beta * d
        iters += 1
    metrics.count("unwrap.calls")
    metrics.count("unwrap.cg_iters", iters)

    # Remove the nullspace drift relative to the anchor, then snap to
    # congruence with the measurement.
    wsum = torch.clamp(quality.sum(), min=1e-20)
    shift = torch.sum(quality * (p - anc)) / wsum
    p = p - shift + torch.round(shift / period) * period
    k = torch.round((p - psi) / period)
    out = psi + k * period
    if not return_info:
        return out
    res = residues(psi, period)
    sus = suspect_edges(out, psi, period, quality)
    dis = (out - anc).abs() > period / 2.0
    info = {
        "cg_iters": iters,
        "rel_residual": torch.sqrt(torch.sum(r * r)) / b_norm,
        "residue_count": res.abs().sum(),
        "suspect": sus,
        "suspect_count": sus.sum(),
        "anchor_disagreement": dis,
        "anchor_disagreement_count": dis.sum(),
    }
    return out, info


def unwrap_to_reference(psi: torch.Tensor, period: float,
                        reference: torch.Tensor) -> torch.Tensor:
    """Pointwise temporal re-anchor: the fringe order that brings psi
    closest to ``reference``."""
    k = torch.round((reference.float() - psi) / period)
    return psi + k * period
