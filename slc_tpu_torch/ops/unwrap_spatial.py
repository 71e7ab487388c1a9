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

- The CG loop is a Python loop that reads the stopping test back to the
  host once per iteration (slc_tpu runs ``lax.while_loop`` on the
  device). On the card its start and each iteration are replays of two
  CUDA graphs, a few thousand small launches each, so the host no
  longer paces the card.
- The transfer operators take the strided form on every device
  (slc_tpu's CPU branch of ``_tpu_layout``; its TPU branch differs only
  in float association).
- Levels with ``min(h, w) >= MG_KERNEL_MIN`` run their descent and
  ascent through ``kernels.mgsmooth`` (the hand-written CUDA kernels on a
  CUDA tensor, the same ops as below on the CPU), slc_tpu's own level
  rule (unwrap_spatial.py:240). The coarsest level's 32 sweeps, a
  ``fori_loop`` in slc_tpu, run as one launch of ``mgsmooth.mg_coarse``
  on a CUDA tensor where the level fits one thread block
  (:func:`coarse_kernel_fits`), else as the plain ops.
- torch sums in another order than XLA, so the CG iteration count may
  differ from slc_tpu's by one; the congruence snap gives the same fringe
  orders.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

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
#: Coarsest levels of at most this many pixels run through
#: kernels.mgsmooth.mg_coarse: one thread block holds the level in shared
#: memory at 24 B a pixel, 192 KiB here of an H100's 227 KiB.
MG_COARSE_KERNEL_MAX = 8192


def coarse_kernel_fits(h: int, w: int) -> bool:
    """Whether an (h, w) coarsest level takes the coarse kernel (on a
    CUDA tensor; the CPU takes the plain ops whatever the shape)."""
    return h * w <= MG_COARSE_KERNEL_MAX


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
    from slc_tpu_torch.kernels import mgsmooth
    wy, wx, dinv, (h, w) = levels[0]
    if len(levels) == 1:
        vcycle.coarse_visits += 1
        coarse = (mgsmooth.mg_coarse if coarse_kernel_fits(h, w)
                  else mgsmooth.mg_coarse_ref)
        return coarse(r, wy, wx, dinv, omega, coarse_sweeps)
    fused = nu == 2 and min(h, w) >= MG_KERNEL_MIN
    if fused:
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


#: The coarsest-level visits of :func:`vcycle` in this process, kernel or
#: plain; CUDA graph replays add those their graph holds.
vcycle.coarse_visits = 0


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


class _CG(NamedTuple):
    """The CG's state between iterations: the operator's edge weights,
    the preconditioner's data (the multigrid levels, or the Jacobi
    inverse diagonal), the iterate ``p``, the residual ``r``, the
    preconditioned residual ``z``, the direction ``d``, the norm of the
    right-hand side and the stopping test's flag, a device bool."""
    wy: torch.Tensor
    wx: torch.Tensor
    pre: object
    p: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    d: torch.Tensor
    b_norm: torch.Tensor
    go: torch.Tensor


#: The fields of :class:`_CG` that an iteration changes.
_MOVING = ("p", "r", "z", "d", "go")


def _precond(pre, r: torch.Tensor) -> torch.Tensor:
    """The K-cycle over the levels ``pre``, or Jacobi by its inverse
    diagonal."""
    return vcycle(r, pre) if isinstance(pre, list) else pre * r


def _go(r: torch.Tensor, b_norm: torch.Tensor, tol: float) -> torch.Tensor:
    """The stopping test on the device: the residual norm above
    ``tol`` times b's norm."""
    return torch.sqrt(torch.sum(r * r)) > tol * b_norm


def _cg_start(psi: torch.Tensor, quality: torch.Tensor, anc: torch.Tensor,
              period: float, tol: float, mg: bool) -> _CG:
    """The normal equations, the preconditioner and the CG's first state
    from the anchor: everything before the first stopping test."""
    dy, dx = wrapped_gradients(psi, period)
    wy, wx = edge_weights(quality)
    b = _rhs(dy, dx, wy, wx)
    if mg:
        with metrics.span("unwrap.levels"):
            pre = build_mg_levels(wy, wx, psi.shape[0], psi.shape[1])
    else:
        pre = 1.0 / _diag(wy, wx)
    r = b - _matvec(anc, wy, wx)
    z = _precond(pre, r)
    b_norm = torch.sqrt(torch.sum(b * b)) + 1e-20
    return _CG(wy, wx, pre, anc, r, z, z, b_norm, _go(r, b_norm, tol))


def _cg_iterate(st: _CG, tol: float) -> _CG:
    """One preconditioned CG iteration and the next stopping test."""
    r, z, d = st.r, st.z, st.d
    ad = _matvec(d, st.wy, st.wx)
    rz = torch.sum(r * z)
    alpha = rz / torch.clamp(torch.sum(d * ad), min=1e-20)
    p = st.p + alpha * d
    r_new = r - alpha * ad
    z_new = _precond(st.pre, r_new)
    # Flexible (Polak-Ribiere+) beta for the K-cycle's mildly nonlinear
    # preconditioner.
    beta = torch.clamp(torch.sum(z_new * (r_new - r))
                       / torch.clamp(rz, min=1e-20), min=0.0)
    return st._replace(p=p, r=r_new, z=z_new, d=z_new + beta * d,
                       go=_go(r_new, st.b_norm, tol))


def _above(go: torch.Tensor) -> bool:
    """The stopping test's flag read back to the host: the span
    ``unwrap.wait``."""
    with metrics.span("unwrap.wait"):
        return bool(go)


def _coarse_counts() -> Tuple[int, int]:
    """vcycle's coarsest visits and the coarse kernel's launches so
    far."""
    from slc_tpu_torch.kernels import mgsmooth
    return vcycle.coarse_visits, mgsmooth.mg_coarse_cuda.launches


def _count_coarse(visits: int, kernel: int) -> None:
    """The counters ``unwrap.coarse_visits`` and ``unwrap.coarse_kernel``
    (the visits that were a launch of the coarse kernel)."""
    metrics.count("unwrap.coarse_visits", visits)
    metrics.count("unwrap.coarse_kernel", kernel)


def _cg_eager(psi: torch.Tensor, quality: torch.Tensor, anc: torch.Tensor,
              period: float, tol: float, mg: bool, max_iters: int
              ) -> Tuple[_CG, int]:
    """The CG loop launch by launch: the final state and the iteration
    count. Every read-back is one stopping test."""
    visits, kernel = _coarse_counts()
    st = _cg_start(psi, quality, anc, period, tol, mg)
    iters = 0
    while iters < max_iters and _above(st.go):
        st = _cg_iterate(st, tol)
        iters += 1
    now = _coarse_counts()
    _count_coarse(now[0] - visits, now[1] - kernel)
    return st, iters


class _CGGraphs:
    """The CG loop of one shape on one card as two CUDA graphs: ``start``
    (:func:`_cg_start` from the static inputs ``psi``, ``quality`` and
    ``anchor``) and ``iterate`` (:func:`_cg_iterate`, its results copied
    back into the state ``start`` made). The same functions as the eager
    loop, so the same kernels in the same order: a replay enqueues a few
    thousand launches at once.

    Before capturing, the kernel library is loaded and the two bodies
    run once eagerly. The two graphs share one memory pool and the
    state; the launch counts of the multigrid kernels and vcycle's
    coarsest visits are left as they were and each replay adds what its
    graph holds. The graphs, their pool and the buffers live as long as
    this object."""

    def __init__(self, dev: torch.device, h: int, w: int, period: float,
                 tol: float, mg: bool):
        from slc_tpu_torch.kernels import _build, mgsmooth
        self.tol = tol
        self.kernels = (mgsmooth.mg_down_cuda, mgsmooth.mg_up_cuda,
                        mgsmooth.mg_coarse_cuda)
        self.psi, self.quality, self.anchor = (
            torch.zeros((h, w), dtype=torch.float32, device=dev)
            for _ in range(3))
        self.dev = dev
        _build.lib()
        before = [k.launches for k in self.kernels]
        visits = vcycle.coarse_visits
        try:
            with torch.cuda.device(dev):
                _cg_iterate(self._start_body(period, mg), tol)
                torch.cuda.synchronize(dev)
                self.start = torch.cuda.CUDAGraph()
                self.start_launches = self._capture(
                    self.start, None, lambda: self._start_body(period, mg))
                self.iterate = torch.cuda.CUDAGraph()
                self.iterate_launches = self._capture(
                    self.iterate, self.start.pool(), self._iterate_body)
        finally:
            for k, n in zip(self.kernels, before):
                k.launches = n
            vcycle.coarse_visits = visits

    def _start_body(self, period: float, mg: bool) -> _CG:
        st = _cg_start(self.psi, self.quality, self.anchor, period,
                       self.tol, mg)
        # The iteration writes p and d in place: neither may alias the
        # anchor or z.
        self.st = st._replace(p=st.p.clone(), d=st.d.clone())
        return self.st

    def _iterate_body(self) -> None:
        new = _cg_iterate(self.st, self.tol)
        for name in _MOVING:
            getattr(self.st, name).copy_(getattr(new, name))

    def _capture(self, graph, pool, body) -> Tuple[list, int]:
        """Capture ``body`` into ``graph``; the multigrid kernels'
        launches and vcycle's coarsest visits it holds."""
        before = [k.launches for k in self.kernels]
        visits = vcycle.coarse_visits
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            body()
        metrics.count("unwrap.graph_captures")
        return ([k.launches - n for k, n in zip(self.kernels, before)],
                vcycle.coarse_visits - visits)

    def _replay(self, graph, held) -> None:
        launches, visits = held
        graph.replay()
        for k, n in zip(self.kernels, launches):
            k.launches += n
        vcycle.coarse_visits += visits
        metrics.count("unwrap.graph_replays")
        _count_coarse(visits, launches[2])

    def run(self, psi: torch.Tensor, quality: torch.Tensor,
            anc: torch.Tensor, max_iters: int) -> Tuple[_CG, int]:
        """:func:`_cg_eager` by replays: the final state (the graphs'
        buffers, valid until the next call) and the iteration count."""
        for dst, src in ((self.psi, psi), (self.quality, quality),
                         (self.anchor, anc)):
            dst.copy_(src)
        with torch.cuda.device(self.dev):
            self._replay(self.start, self.start_launches)
            iters = 0
            while iters < max_iters and _above(self.st.go):
                self._replay(self.iterate, self.iterate_launches)
                iters += 1
        return self.st, iters


@functools.lru_cache(maxsize=4)
def _cg_graphs(dev: torch.device, h: int, w: int, period: float,
               tol: float, mg: bool) -> _CGGraphs:
    """The captured CG loop of one card, shape, period, tolerance and
    preconditioner, captured on first use."""
    return _CGGraphs(dev, h, w, period, tol, mg)


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

    A CPU tensor runs the CG loop launch by launch; any other takes the
    loop's two CUDA graphs for its card, shape, ``period``, ``tol`` and
    ``mg`` (:class:`_CGGraphs`, captured on the first call, the last
    four such kept), or raises. Both run the same kernels in the same
    order and read the stopping test back once an iteration.

    Under a profiler it counts ``unwrap.calls`` (1 a call),
    ``unwrap.cg_iters`` (its CG iterations), ``unwrap.coarse_visits``
    (the K-cycle's coarsest-level visits: with ``mg``, a fixed number a
    preconditioner call, 1 + ``cg_iters`` calls), ``unwrap.coarse_kernel``
    (those that were a launch of the coarse kernel) and, on the graphs,
    ``unwrap.graph_replays`` (1 a replay: 1 + ``cg_iters`` a call) and
    ``unwrap.graph_captures`` (2 a capture); it spans ``unwrap.levels``
    (the multigrid hierarchy's enqueue, eager or captured) and
    ``unwrap.wait`` (each read-back of the stopping test, a wait on the
    device)."""
    psi = psi.float()
    if quality is None:
        quality = torch.ones_like(psi)
    quality = quality.float()
    anc = anchor.float() if anchor is not None else psi
    if psi.device.type == "cpu":
        st, iters = _cg_eager(psi, quality, anc, period, tol, mg, max_iters)
    else:
        st, iters = _cg_graphs(psi.device, psi.shape[0], psi.shape[1],
                               float(period), float(tol), bool(mg)).run(
            psi, quality, anc, max_iters)
    metrics.count("unwrap.calls")
    metrics.count("unwrap.cg_iters", iters)

    # Remove the nullspace drift relative to the anchor, then snap to
    # congruence with the measurement. Every tensor returned is new: on
    # the graphs, st holds their buffers.
    wsum = torch.clamp(quality.sum(), min=1e-20)
    shift = torch.sum(quality * (st.p - anc)) / wsum
    p = st.p - shift + torch.round(shift / period) * period
    k = torch.round((p - psi) / period)
    out = psi + k * period
    if not return_info:
        return out
    res = residues(psi, period)
    sus = suspect_edges(out, psi, period, quality)
    dis = (out - anc).abs() > period / 2.0
    info = {
        "cg_iters": iters,
        "rel_residual": torch.sqrt(torch.sum(st.r * st.r)) / st.b_norm,
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
