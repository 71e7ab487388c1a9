"""Phase unwrapping: Gray-assisted merge and multi-frequency heterodyne
(PyTorch port of slc_tpu/ops/unwrap.py).

Gray-assisted merge is the reference's frame-0 absolute decode
(DynaFrame/CCalculation.cpp:561-587): the fringe period T equals two Gray
bins, and the Gray bin parity says which half-period the wrapped phase
belongs to, with a guard band correcting phase values that wrapped into
the adjacent bin.

Heterodyne unwrapping is new relative to the reference: a cascade of
pairwise beat phases extends the unambiguous range from the finest
fringe period to the full projector width, then unwraps back down the
cascade by fringe-order rounding.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def gray_assisted_merge(gray_coord: torch.Tensor,
                        wrapped_phase: torch.Tensor,
                        gray_period: float, phase_period: float
                        ) -> torch.Tensor:
    """Merge an absolute Gray coordinate with a wrapped fringe phase,
    T = phase_period = 2 * gray_period (CCalculation.cpp:550,563):

      even Gray bin:  phase > 0.75 T  ->  phase -= T
      odd  Gray bin:  phase < 0.25 T  ->  phase += T ;  then phase -= T/2
      P = gray_coord + phase
    """
    t = float(phase_period)
    bin_idx = (gray_coord / gray_period).to(torch.int32)
    even = (bin_idx % 2) == 0
    ph = wrapped_phase
    ph_even = torch.where(ph > 0.75 * t, ph - t, ph)
    ph_odd = torch.where(ph < 0.25 * t, ph + t, ph) - 0.5 * t
    return gray_coord + torch.where(even, ph_even, ph_odd)


def _wrap_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fractional wrap of (a - b) into [0, 1)."""
    d = a - b
    return d - torch.floor(d)


def beat_periods(periods: Sequence[float], extent: float
                 ) -> Tuple[List[float], float]:
    """The left spine of the beat pyramid: ``spine[l]`` is the period of
    the leftmost phase of level l (level 0 = the finest input period),
    computed in Python floats as slc_tpu/ops/unwrap.py:80-88 does, and
    the coarse period at the top. Raises ValueError when the cascade
    does not reach ``extent``."""
    level = [float(p) for p in periods]
    spine = []
    while len(level) > 1:
        spine.append(level[0])
        level = [level[i] * level[i + 1] / abs(level[i + 1] - level[i])
                 for i in range(len(level) - 1)]
    coarse = level[0]
    if coarse < extent - 1e-6:
        raise ValueError(
            f"heterodyne cascade reaches only {coarse:.1f} px of the "
            f"required {extent} px; choose closer periods")
    return spine, coarse


def heterodyne_unwrap(wrapped: torch.Tensor, periods: Sequence[float],
                      extent: float) -> torch.Tensor:
    """Multi-frequency heterodyne (beat) unwrapping
    (slc_tpu/ops/unwrap.py:51-104).

    ``wrapped`` is (F, H, W): ``wrapped[f] = x mod periods[f]``, finest
    period first. Fractional phases u_f = wrapped_f / T_f beat pairwise,
    u = frac(u_f - u_{f+1}) with period T_f*T_{f+1}/|T_{f+1}-T_f|, up to
    one coarse phase spanning ``extent``; then the coordinate is unwrapped
    back down the left spine, k = round(x/T - u), x = (k + u) * T, and
    wrapped into [0, extent). Returns (H, W) float32."""
    spine, coarse_period = beat_periods(periods, extent)
    fracs = [wrapped[i] / float(p) for i, p in enumerate(periods)]
    spine_fracs = []
    while len(fracs) > 1:
        spine_fracs.append(fracs[0])
        fracs = [_wrap_delta(fracs[i], fracs[i + 1])
                 for i in range(len(fracs) - 1)]
    x = fracs[0] * coarse_period
    for u, p in zip(reversed(spine_fracs), reversed(spine)):
        k = torch.round(x / p - u)
        x = (k + u) * p
    # Noise near the extent boundary can round the coarse order past the
    # unambiguous range (x ~ -T0 or ~ extent): wrap back into [0, extent).
    return x - extent * torch.floor(x / extent)
