"""Gray-assisted phase unwrapping (PyTorch port of the Gray half of
slc_tpu/ops/unwrap.py; heterodyne unwrapping is not ported yet).

The reference's frame-0 absolute decode (DynaFrame/CCalculation.cpp:
561-587): the fringe period T equals two Gray bins, and the Gray bin
parity says which half-period the wrapped phase belongs to, with a guard
band correcting phase values that wrapped into the adjacent bin.
"""

from __future__ import annotations

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
