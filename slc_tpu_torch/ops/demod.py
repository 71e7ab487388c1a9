"""Single-frame stripe-phase demodulation for phase-locked tracking
(PyTorch port of slc_tpu/ops/demod.py; the module docstring there has
the derivation).

Every dynamic frame is lit by I(u, v) = A cos(2*pi*P(u, v)/T) + A. Lock-in
demodulation against the predicted carrier phi_pred = 2*pi*P_pred/T with
the local mean removed gives C ~ (A/2) cos(delta), S ~ (A/2) sin(-delta),
so delta = atan2(-S, C) and P = P_pred + delta * T / (2*pi) snaps the
integrated map to phase congruence each frame. The low-pass is a
separable TRIANGLE (box applied twice), whose sinc^2 response keeps the
closed loop a contraction; a plain box diverges (slc_tpu/ops/demod.py:
30-54).

These are plain tensor functions. On the card the locked step runs them
inside the hand-written kernel (slc_tpu_torch.kernels.dynamic_step);
``estimate_period`` runs as plain PyTorch on every device, as slc_tpu
computes it outside any kernel; ``suggest_lock_window`` takes its median
on the card (slc_tpu_torch.kernels.lock_window) where the map is there
or a card is present, else with numpy, as slc_tpu does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import lock_window as klw

#: Row-band height of the carrier-consistency gate (slc_tpu/ops/demod.py:
#: 67-73). Bands align to global row 0; the CUDA kernel takes its band
#: height from here.
GATE_BAND = 64

_TWO_PI = 2.0 * math.pi


def _box_sum_1d(x: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    """Centered ``win``-tap box sum along ``dim``, zero-padded, through a
    zero-prepended cumulative sum (slc_tpu/ops/demod.py:76-89)."""
    r = win // 2
    rr = win - 1 - r
    n = x.shape[dim]
    pad = (r, rr, 0, 0) if dim == 1 else (0, 0, r, rr)
    s = torch.cumsum(F.pad(x, pad), dim)
    zshape = list(x.shape)
    zshape[dim] = 1
    s = torch.cat([torch.zeros(zshape, dtype=x.dtype, device=x.device), s],
                  dim)
    return s.narrow(dim, win, n) - s.narrow(dim, 0, n)


def _tri_sum(x: torch.Tensor, win_v: int, win_u: int) -> torch.Tensor:
    """Separable triangle-kernel sum: box(win) applied twice per axis,
    columns first. Each box pass is zero-padded at the image edge, so
    the intermediate is truncated to the image too."""
    x = _box_sum_1d(_box_sum_1d(x, win_u, 1), win_u, 1)
    return _box_sum_1d(_box_sum_1d(x, win_v, 0), win_v, 0)


def tri_weights_1d(n: int, win: int) -> np.ndarray:
    """Exact in-image weight of the zero-padded double box along one
    axis of length ``n`` (float32, integer-valued)."""
    ones = torch.ones((1, n), dtype=torch.float32)
    return _box_sum_1d(_box_sum_1d(ones, win, 1), win, 1)[0].numpy()


def _tri_weight(h: int, w: int, win_v: int, win_u: int,
                device) -> torch.Tensor:
    """Per-pixel total in-image weight of the triangle window, the
    separable product wv(row) x wu(col) (slc_tpu/ops/demod.py:100-107)."""
    wu = torch.from_numpy(tri_weights_1d(w, win_u)).to(device)
    wv = torch.from_numpy(tri_weights_1d(h, win_v)).to(device)
    return wv[:, None] * wu[None, :]


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] without trig round trips."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def lock_in(frame: torch.Tensor, proj_u_pred: torch.Tensor, period: float,
            win_u: int, win_v: int, dtype=torch.float32
            ) -> Tuple[torch.Tensor, ...]:
    """The lock-in's per-pixel quantities (slc_tpu/ops/demod.py:113-201),
    in float32 as :func:`stripe_phase_correction` computes them (or in
    ``dtype``, float64 to check a float32 computation against): the
    window's phase offset delta_phi = atan2(-S, C) in (-pi, pi], the two
    arccos readings' wrapped distances d_pos, d_neg from the
    window-corrected prediction, the sin^2 confidence and the amplitude.
    Their branch points (delta_phi's and the readings' wraps at +-pi, the
    choice |d_pos| = |d_neg|) and the amplitude gate are where two
    correct float implementations may decide apart: the corrected P then
    differs by up to one period."""
    h, w = frame.shape
    f = frame.to(dtype)
    wgt = _tri_weight(h, w, win_v, win_u, frame.device).to(dtype)
    dc = _tri_sum(f, win_v, win_u) / wgt
    iac = f - dc
    phi = (_TWO_PI / period) * proj_u_pred.to(dtype)
    c = _tri_sum(iac * torch.cos(phi), win_v, win_u)
    s = _tri_sum(iac * torch.sin(phi), win_v, win_u)
    amp = torch.sqrt(c * c + s * s) / wgt
    delta_phi = torch.atan2(-s, c)
    cos_phi = (iac / torch.clamp(2.0 * amp, min=1e-6)).clamp(-1.0, 1.0)
    phi_mag = torch.arccos(cos_phi)                     # [0, pi]
    phi_ref = phi + delta_phi                           # window-corrected
    d_pos = _wrap(phi_mag - phi_ref)
    d_neg = _wrap(-phi_mag - phi_ref)
    conf = 1.0 - cos_phi * cos_phi                      # sin^2(phi)
    return delta_phi, d_pos, d_neg, conf, amp


def stripe_phase_correction(frame: torch.Tensor, proj_u_pred: torch.Tensor,
                            period: float, win_u: int = 9,
                            win_v: int = 9, amp_floor: float = 8.0,
                            max_carrier_gradient: float = 2e-3,
                            gates: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lock-in demodulation of one dynamic stripe frame against the
    predicted projector map (slc_tpu/ops/demod.py:113-225).

    ``win_u`` / ``win_v``: low-pass extents in camera px (triangle of
    full support ``2*win - 1`` per axis). ``amp_floor``: pixels whose
    demodulated amplitude is at or below it get no correction. Each
    pixel is refined by its own arccos reading against the
    window-corrected prediction, blended by sin^2(phi) (slc_tpu's
    default ``per_pixel=True``, the only setting its callers use).
    ``max_carrier_gradient``: per GATE_BAND-row band, the amplitude-gated
    mean of the wrapped column gradient of delta_phi must stay within
    it, or the band's correction is zeroed (a mis-specified period
    leaves a constant gradient). 0 or inf turns the gate off. ``gates``
    (optional, float32, one per band) receives each band's decision: 1
    where its correction is kept, 0 where the gate zeroed it.

    Returns (delta_p, amplitude): the additive projector-column
    correction (zero where gated) and the demodulated amplitude.
    """
    h = frame.shape[0]
    delta_phi, d_pos, d_neg, conf, amp = lock_in(frame, proj_u_pred, period,
                                                 win_u, win_v)
    d_px = torch.where(d_pos.abs() <= d_neg.abs(), d_pos, d_neg)
    delta_p = (delta_phi + conf * d_px) * (period / _TWO_PI)
    ok = (amp > amp_floor) & (proj_u_pred > 0)
    gate_on = bool(max_carrier_gradient) and math.isfinite(
        max_carrier_gradient)
    if gates is not None and not gate_on:
        gates.fill_(1.0)
    if gate_on:
        gx = _wrap(delta_phi[:, 1:] - delta_phi[:, :-1])
        gm = (ok[:, 1:] & ok[:, :-1]).float()
        hb = -(-h // GATE_BAND) * GATE_BAND

        def band_sum(x):
            xp = F.pad(x, (0, 0, 0, hb - h))
            return xp.reshape(hb // GATE_BAND, GATE_BAND, -1).sum((1, 2))
        g = band_sum(gx * gm) / torch.clamp(band_sum(gm), min=1.0)
        gate = g.abs() <= max_carrier_gradient
        if gates is not None:
            gates.copy_(gate)
        gate_rows = torch.repeat_interleave(gate, GATE_BAND)[:h]
        ok = ok & gate_rows[:, None]
    return torch.where(ok, delta_p, torch.zeros_like(delta_p)), amp


def estimate_period(frame: torch.Tensor, proj_u: torch.Tensor,
                    period_nominal: float, win_u: int = 9,
                    win_v: int = 9, amp_floor: float = 8.0,
                    iters: int = 2) -> torch.Tensor:
    """Refine the stripe period from one dynamic frame and an absolute
    projector map (slc_tpu/ops/demod.py:231-294): demodulating at T_nom
    against the true map leaves delta_phi with slope
    m = 2*pi*(1/T_true - 1/T_nom) per projector px, estimated by
    amplitude-gated least squares of column gradients; ``iters=2``
    re-demodulates at the first estimate. Valid to ~+-10% initial
    error. Returns a float32 scalar tensor. Its host time (the enqueue on
    the card; the caller's read of the scalar waits) is the span
    ``setup.period``."""
    with metrics.span("setup.period"):
        return _estimate_period(frame, proj_u, period_nominal, win_u, win_v,
                                amp_floor, iters)


def _estimate_period(frame, proj_u, period_nominal, win_u, win_v,
                     amp_floor, iters):
    h, w = frame.shape
    f = frame.float()
    pu = proj_u.float()
    wgt = _tri_weight(h, w, win_v, win_u, frame.device)
    dc = _tri_sum(f, win_v, win_u) / wgt
    iac = f - dc
    g_pu = pu[:, 1:] - pu[:, :-1]

    def refine(t):
        phi = (_TWO_PI / t) * pu
        c = _tri_sum(iac * torch.cos(phi), win_v, win_u)
        s = _tri_sum(iac * torch.sin(phi), win_v, win_u)
        amp = torch.sqrt(c * c + s * s) / wgt
        dphi = torch.atan2(-s, c)
        ok = (amp > amp_floor) & (pu > 0)
        m_ok = (ok[:, 1:] & ok[:, :-1]).float()
        g_phi = _wrap(dphi[:, 1:] - dphi[:, :-1])
        num = (g_phi * g_pu * m_ok).sum()
        den = torch.clamp((g_pu * g_pu * m_ok).sum(), min=1e-6)
        return 1.0 / (1.0 / t + (num / den) / _TWO_PI)

    t = torch.tensor(period_nominal, dtype=torch.float32,
                     device=frame.device)
    for _ in range(iters):
        t = refine(t)
    return t


def _on_card(pu) -> Optional[torch.Tensor]:
    """``pu`` as a float32 (H, W) tensor on a card, or None for the host
    path: a card's float32 tensor as it is; a float32 numpy map uploaded
    to the current card where there is one."""
    if isinstance(pu, torch.Tensor):
        ok = (pu.device.type == "cuda" and pu.dtype == torch.float32
              and pu.ndim == 2)
        return pu if ok else None
    if (isinstance(pu, np.ndarray) and pu.dtype == np.float32
            and pu.ndim == 2 and torch.cuda.is_available()):
        return torch.from_numpy(np.ascontiguousarray(pu)).to(
            torch.device("cuda", torch.cuda.current_device()))
    return None


def suggest_lock_window(proj_u0, period: float,
                        periods_per_window: float = 1.0,
                        max_window: int = 64) -> int:
    """Lock-in triangle half-width (camera px) from the frame-0 absolute
    map: T / median(dP/du) times ``periods_per_window``, odd, in
    [3, max_window] (slc_tpu/ops/demod.py:297-314). A float32 (H, W) map
    on a card, or in host memory where a card is present (copied to the
    current card first), takes the median on the card (the counter
    ``setup.lock_window_card``); anything else, host numpy. Either gives
    the same median bit for bit. Its time is the span
    ``setup.lock_window``."""
    with metrics.span("setup.lock_window"):
        card = _on_card(proj_u0)
        n, lo, hi = klw.middle_abs_gradients(
            proj_u0 if card is None else card)
        # np.median's own finish: the mean of the two middle values.
        med = float(np.mean([lo, hi])) if n else 1.0
        if card is not None:
            metrics.count("setup.lock_window_card")
    win = int(round(periods_per_window * period / max(med, 1e-3)))
    win = int(np.clip(win, 3, max_window))
    return win if win % 2 else win - 1            # odd, bounded
