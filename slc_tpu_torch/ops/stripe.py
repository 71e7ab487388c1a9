"""Stripe-extremum tracking for dynamic frames: the plain PyTorch
composite (port of slc_tpu/ops/stripe.py). :func:`stripe_regression`
here is the plain version on any device; the hand-written kernel and the
dispatching ``stripe_regression`` live in
:mod:`slc_tpu_torch.kernels.stripe`.

Reference behavior (DynaFrame/CCalculation.cpp:789-891), per frame:

1. ``valSum(h, w)``: vertical 21-row box sum of the raw camera image per
   column on the interior [r, H-r) x [r, W-r), r = window//2; zero
   elsewhere (CCalculation.cpp:797-823).
2. Per interior pixel, scan horizontal offsets i in [-r, r) (+r is
   EXCLUDED) over valSum(h, w+i), tracking a running max and min that
   start at the center value and update on strict inequality
   (CCalculation.cpp:828-850): the center wins any tie, otherwise the
   smallest offset attaining the extremum. The offsets are stripW
   (bright) and stripB (dark), zero on the border.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _interior(h: int, w: int, r: int, device) -> torch.Tensor:
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= r) & (row < h - r) & (col >= r) & (col < w - r)


def box_sum_vertical_raw(frame: torch.Tensor, window: int) -> torch.Tensor:
    """Vertical ``window``-row box sum centred on each row, the frame
    zero-padded above and below, no interior mask (slc_tpu/ops/stripe.py:
    35-53): the shared core of the image and the tile-parallel paths.
    Summed in int32, exact as the reference's rolling integer DP;
    returned as float32 (u8 sums are exact in float32, so this equals
    slc_tpu's float cumsum)."""
    r = window // 2
    w = frame.shape[1]
    fp = F.pad(frame.to(torch.int32), (0, 0, r, r))
    s = torch.cat([torch.zeros((1, w), dtype=torch.int32,
                               device=frame.device),
                   torch.cumsum(fp, 0, dtype=torch.int32)], 0)
    return (s[window:] - s[:-window]).float()


def box_sum_vertical(frame: torch.Tensor, window: int) -> torch.Tensor:
    """Vertical ``window``-row box sum, interior-only, border zeroed
    (CCalculation.cpp:797-823)."""
    h, w = frame.shape
    box = box_sum_vertical_raw(frame, window)
    return torch.where(_interior(h, w, window // 2, frame.device), box,
                       torch.zeros_like(box))


def quantize_frac(frac: torch.Tensor, fbits: int) -> torch.Tensor:
    """The fast sub-pixel mode's fraction (slc_tpu/pallas/mathx.py:
    332-376, read back at :428): q = trunc(clip(S/2 + 1/2 - S*frac, 0,
    S-1)) with S = 2^fbits, returned as (S/2 - q)/S, a multiple of 1/S in
    [-(S/2 - 1)/S, 1/2]."""
    s = float(1 << fbits)
    q = ((0.5 * s + 0.5) - s * frac).clamp(0.0, s - 1.0).trunc()
    return (0.5 * s - q) / s


def windowed_extrema_raw(val_sum: torch.Tensor, window: int,
                         subpixel: bool = False, fbits: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel offsets of the max/min of val_sum over horizontal
    offsets [-r, r), unmasked (slc_tpu/ops/stripe.py:68-112): the shared
    core of the image and the tile-parallel paths, whose callers mask
    the interior in their own coordinates. ``subpixel`` and ``fbits`` as
    in :func:`windowed_extrema`."""
    r = window // 2

    def rolled(i):
        # valSum(h, w+i); the wrap only touches masked border pixels.
        return torch.roll(val_sum, -i, dims=1)

    best_max = val_sum
    best_max_idx = torch.zeros_like(val_sum)
    best_min = val_sum
    best_min_idx = torch.zeros_like(val_sum)
    if subpixel:
        max_vm = min_vm = rolled(-1)
        max_vp = min_vp = rolled(1)
    v_prev = rolled(-r - 1)
    v = rolled(-r)
    for i in range(-r, r):
        v_next = rolled(i + 1)
        upd_max = v > best_max
        best_max = torch.where(upd_max, v, best_max)
        best_max_idx = torch.where(upd_max, float(i), best_max_idx)
        upd_min = v < best_min
        best_min = torch.where(upd_min, v, best_min)
        best_min_idx = torch.where(upd_min, float(i), best_min_idx)
        if subpixel:
            max_vm = torch.where(upd_max, v_prev, max_vm)
            max_vp = torch.where(upd_max, v_next, max_vp)
            min_vm = torch.where(upd_min, v_prev, min_vm)
            min_vp = torch.where(upd_min, v_next, min_vp)
        v_prev, v = v, v_next

    if subpixel:
        def refine(idx, v0, vm, vp):
            denom = vm - 2.0 * v0 + vp
            frac = torch.where(denom.abs() > 1e-6, 0.5 * (vm - vp) / denom,
                               torch.zeros_like(denom)).clamp(-0.5, 0.5)
            if fbits:
                # The center never wins by an update: idx == 0 is a tie.
                frac = torch.where(idx == 0, frac, quantize_frac(frac, fbits))
            return idx + frac
        best_max_idx = refine(best_max_idx, best_max, max_vm, max_vp)
        best_min_idx = refine(best_min_idx, best_min, min_vm, min_vp)

    return best_max_idx, best_min_idx


def windowed_extrema(val_sum: torch.Tensor, window: int,
                     subpixel: bool = False, fbits: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel offsets of the max/min of val_sum over horizontal
    offsets [-r, r), reference scan semantics (CCalculation.cpp:
    828-891), as slc_tpu/ops/stripe.py:68-148 computes them.

    ``subpixel``: refine each extremum by a parabola through its two
    horizontal neighbors, offset += (v[-1]-v[+1]) / (2*(v[-1]-2v0+v[+1])),
    clamped to +-0.5. ``fbits`` > 0 (fast sub-pixel mode) quantizes the
    fraction of every winner but the center to ``fbits`` bits
    (:func:`quantize_frac`); a center tie keeps the exact fraction, as
    slc_tpu's TPU kernels do.

    Returns (strip_w, strip_b): float32 offsets (bright, dark), zero
    outside the interior.
    """
    h, w = val_sum.shape
    best_max_idx, best_min_idx = windowed_extrema_raw(val_sum, window,
                                                      subpixel, fbits)
    interior = _interior(h, w, window // 2, val_sum.device)
    zero = torch.zeros_like(val_sum)
    return (torch.where(interior, best_max_idx, zero),
            torch.where(interior, best_min_idx, zero))


def stripe_regression(frame: torch.Tensor, window: int,
                      subpixel: bool = False, fbits: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full per-frame stripe tracking (CCalculation::StripRegression,
    CCalculation.cpp:789-891): raw (H, W) camera frame -> (strip_w,
    strip_b) float32 offset maps, by the plain composite on the frame's
    device. ``fbits`` as in :func:`windowed_extrema`."""
    return windowed_extrema(box_sum_vertical(frame, window), window,
                            subpixel, fbits)


def select_delta_p(strip_w_prev: torch.Tensor, strip_b_prev: torch.Tensor,
                   strip_w_cur: torch.Tensor, strip_b_cur: torch.Tensor,
                   robust: bool = False) -> torch.Tensor:
    """Delta-P selection (CCalculation.cpp:595-646): take whichever
    stripe family moved less, dX = prev - cur. ``robust``: where the two
    families agree (|dB - dW| <= 1 px) take their mean, which cancels
    the min-|d| rule's rectification bias (slc_tpu/ops/stripe.py:
    161-183)."""
    d_b = strip_b_prev - strip_b_cur
    d_w = strip_w_prev - strip_w_cur
    min_abs = torch.where(d_b.abs() < d_w.abs(), d_b, d_w)
    if not robust:
        return min_abs
    agree = (d_b - d_w).abs() <= 1.0
    return torch.where(agree, 0.5 * (d_b + d_w), min_abs)
