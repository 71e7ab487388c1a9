"""The comparison that decides ``correct``: the program's maps against the
plain reference's, run on the same images after the window has closed.

A map's number is the share of its pixels that are off (farther from
the reference than the bar, a hole on one side only, or not finite), or
a quantile of its gaps. A cell's number is the largest over the maps it
compares.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from slcbench.reference import plain


def _t(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def off_mask(got, want: torch.Tensor, bar: float) -> torch.Tensor:
    """Pixels of ``got`` off from ``want`` (same shape)."""
    got = _t(got, want.device)
    want = want.float()
    return (~torch.isfinite(got) | ((got - want).abs() > bar)
            | ((got == 0) != (want == 0)))


def share(mask: torch.Tensor) -> float:
    return float(mask.float().mean())


class Reference:
    """The plain reference for one configuration on ``device``."""

    def __init__(self, config: dict, cal: Dict[str, np.ndarray], device):
        self.config = config
        self.sysc = config["system"]
        self.device = torch.device(device)
        if config["tracker"].get("frac_bits", 0):
            raise ValueError("the reference tracks with the exact sub-pixel "
                             "fraction only (frac_bits 0)")
        self.tables = plain.build_tables(cal, self.sysc["cam_h"],
                                         self.sysc["cam_w"], self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def decode(self, parts: Sequence[np.ndarray], dt=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z, P) of a frame-0 pattern stack."""
        if self.config["decode"] == "grayphase":
            return plain.decode_grayphase(self._dev(parts[0]),
                                          self._dev(parts[1]), self.tables,
                                          self.sysc, dt)
        h = self.config["heterodyne"]
        return plain.decode_heterodyne(self._dev(parts[0]), self.tables,
                                       self.sysc, h["fringe_counts"],
                                       h["phase_steps"], h["min_modulation"],
                                       dt)

    def track(self, parts: Sequence[np.ndarray], frames: np.ndarray,
              dt=torch.float32) -> Iterator[Tuple[int, torch.Tensor,
                                                  torch.Tensor]]:
        """Decode frame 0, then track every later frame: yields (frame,
        z, P of frame 0) for frame 0 and (frame, z, None) after it."""
        period = float(self.config["stripe_period"])
        z, pu = self.decode(parts, dt)
        yield 0, z, pu
        st = plain.init_tracker(self._dev(frames[0]), pu, self.sysc,
                                self.config["tracker"], period)
        for f in range(1, len(frames)):
            st, z = plain.locked_step(st, self._dev(frames[f]), self.tables,
                                      self.sysc, self.config["tracker"],
                                      period, int(self.config["lock_win_v"]))
            yield f, z, None


def gap_quantile(got, want: torch.Tensor, q: float) -> float:
    """The ``q`` quantile of |z - z_ref| over the pixels that are depth on
    either side (a hole reads as depth 0, a value that is not finite as
    an infinite gap)."""
    got = _t(got, want.device)
    want = want.float()
    d = (got - want).abs()
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    d = d[(got != 0) | (want != 0)]
    if not d.numel():
        return float("nan")
    k = min(d.numel(), max(1, math.ceil(q * d.numel())))
    return float(d.kthvalue(k).values)


def decode_off(z_got, pu_got, z_ref, pu_ref, bars: dict) -> float:
    """Share of a decode's pixels off in z or (where given) in P."""
    m = off_mask(z_got, z_ref, bars["z"])
    if pu_got is not None:
        m = m | off_mask(pu_got, pu_ref, bars["proj_u"])
    return share(m)


def worst(values: List[float]) -> float:
    """The largest share, NaN when nothing was compared (which fails)."""
    return max(values) if values else float("nan")
