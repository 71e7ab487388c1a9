"""Streaming dynamic-frame tracker (PyTorch port of
slc_tpu/dynamic.py:30-224).

The reference's frames 1..N loop (CCalculation::CalculateOther,
DynaFrame/CCalculation.cpp:208-320) carries exactly three arrays between
frames: the projector map P[f-1], the stripe offsets stripW/stripB[f-1],
and z[f-1]. Here that state is a frozen dataclass and the per-frame
update a function returning a new one: every step allocates fresh maps,
so results handed to a background writer are never overwritten.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.calib import TriangulationTables, resolve_device
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.kernels.dynamic_step import (dynamic_step_lock,
                                                dynamic_step_open)
from slc_tpu_torch.kernels.stripe import stripe_regression
from slc_tpu_torch.pipeline import FrameResult


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """Carried state of the dynamic loop (CCalculation.cpp:603-606,
    :656-658, :774). ``frame_idx`` is a host int: nothing on the device
    reads it."""
    proj_u: torch.Tensor    # (H, W) float32 absolute projector map P[f-1]
    strip_w: torch.Tensor   # (H, W) float32 bright-stripe offsets
    strip_b: torch.Tensor   # (H, W) float32 dark-stripe offsets
    z: torch.Tensor         # (H, W) float32 previous depth
    frame_idx: int

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   device="cuda") -> "TrackerState":
        """From numpy arrays keyed by slc_tpu's checkpoint fields
        (proj_u, strip_w, strip_b, z, frame_idx), on the card unless
        ``device`` says otherwise (a CUDA device without CUDA raises)."""
        device = resolve_device(device)

        def f32(k):
            return torch.from_numpy(
                np.asarray(arrays[k], np.float32).copy()).to(device)
        return TrackerState(proj_u=f32("proj_u"), strip_w=f32("strip_w"),
                            strip_b=f32("strip_b"), z=f32("z"),
                            frame_idx=int(np.asarray(arrays["frame_idx"])))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The same fields as numpy arrays (frame_idx as int32)."""
        return {"proj_u": self.proj_u.cpu().numpy(),
                "strip_w": self.strip_w.cpu().numpy(),
                "strip_b": self.strip_b.cpu().numpy(),
                "z": self.z.cpu().numpy(),
                "frame_idx": np.int32(self.frame_idx)}


def init_tracker(frame0: torch.Tensor, proj_u0: torch.Tensor,
                 z0: torch.Tensor, cfg: SystemConfig,
                 subpixel: bool = True) -> TrackerState:
    """Initialize from the absolutely-decoded frame 0
    (CCalculation::StripRegression(0) at CCalculation.cpp:201). Its host
    time is the span ``track.init``."""
    with metrics.span("track.init"):
        sw, sb = stripe_regression(frame0, cfg.reco_window, subpixel)
        return TrackerState(proj_u=proj_u0.float(), strip_w=sw, strip_b=sb,
                            z=z0.float(), frame_idx=0)


def reanchor(state: TrackerState, frame: torch.Tensor,
             proj_u_abs: torch.Tensor, z_abs: torch.Tensor,
             cfg: SystemConfig, subpixel: bool = True) -> TrackerState:
    """Periodic absolute re-anchoring: replace P and z with a fresh
    absolute decode and rebuild the stripe state from the current
    fringe frame, keeping the frame counter (slc_tpu/dynamic.py:55-72)."""
    sw, sb = stripe_regression(frame, cfg.reco_window, subpixel)
    return TrackerState(proj_u=proj_u_abs.float(), strip_w=sw, strip_b=sb,
                        z=z_abs.float(), frame_idx=state.frame_idx)


def dynamic_step(state: TrackerState, frame: torch.Tensor,
                 tables: TriangulationTables, cfg: SystemConfig,
                 scale_gradient: bool = True, subpixel: bool = True,
                 robust: bool = True, phase_lock: Optional[float] = None,
                 lock_win_u: int = 9, lock_win_v: int = 9,
                 frac_bits: int = 0
                 ) -> Tuple[TrackerState, FrameResult]:
    """One dynamic frame (the body of CCalculation::CalculateOther,
    CCalculation.cpp:221-316): stripe track -> deltaP select -> 3x3 mean
    -> P += deltaP -> triangulate.

    ``scale_gradient`` converts camera-pixel stripe motion to projector
    columns by the carried map's local gradient; ``robust`` mean-combines
    agreeing stripe families; ``phase_lock`` (the stripe period T) snaps
    P to the carrier phase demodulated from this very frame. See
    slc_tpu/dynamic.py:101-143 for each one's rationale. All three off
    plus no lock is the reference's exact semantics.

    Its host time (the enqueue on the card) is the span ``track.step``,
    ``frame`` the new state's ``frame_idx``.
    """
    with metrics.span("track.step", frame=state.frame_idx + 1):
        pu, sw, sb, z, x, y = step_maps(
            state, frame, tables, cfg, scale_gradient, subpixel, robust,
            phase_lock, lock_win_u, lock_win_v, frac_bits)
        new_state = TrackerState(proj_u=pu, strip_w=sw, strip_b=sb, z=z,
                                 frame_idx=state.frame_idx + 1)
        return new_state, FrameResult(x=x, y=y, z=z, proj_u=pu)


def step_maps(state: TrackerState, frame: torch.Tensor,
              tables: TriangulationTables, cfg: SystemConfig,
              scale_gradient: bool = True, subpixel: bool = True,
              robust: bool = True, phase_lock: Optional[float] = None,
              lock_win_u: int = 9, lock_win_v: int = 9,
              frac_bits: int = 0, out=None) -> Tuple[torch.Tensor, ...]:
    """The maps of :func:`dynamic_step`, (proj_u, strip_w, strip_b, z, x,
    y). ``out`` (CUDA only): six maps the kernel writes instead of fresh
    ones."""
    kw = dict(window=cfg.reco_window, subpixel=subpixel,
              scale_gradient=scale_gradient, robust=robust,
              fov_min=cfg.fov_min, fov_max=cfg.fov_max, frac_bits=frac_bits)
    if out is not None:
        kw["out"] = out
    if phase_lock is not None:
        return dynamic_step_lock(
            frame, state.strip_w, state.strip_b, state.proj_u, tables,
            period=float(phase_lock), win_u=lock_win_u, win_v=lock_win_v,
            **kw)
    return dynamic_step_open(frame, state.strip_w, state.strip_b,
                             state.proj_u, tables, **kw)


def run_sequence(state: TrackerState, frames: torch.Tensor,
                 tables: TriangulationTables, cfg: SystemConfig,
                 **step_kw) -> Tuple[TrackerState, FrameResult]:
    """Offline batch variant: step the tracker over (F, H, W) frames in
    order (P[f] depends on P[f-1], CCalculation.cpp:656-658). Returns the
    final state and the per-frame results stacked along dim 0."""
    results = []
    for frame in frames:
        state, res = dynamic_step(state, frame, tables, cfg, **step_kw)
        results.append(res)
    return state, FrameResult(
        x=torch.stack([r.x for r in results]),
        y=torch.stack([r.y for r in results]),
        z=torch.stack([r.z for r in results]),
        proj_u=torch.stack([r.proj_u for r in results]))


def delta_z(result_z: torch.Tensor) -> torch.Tensor:
    """Per-frame depth change over a stacked (F, H, W) z sequence: the
    reference's m_deltaZ diagnostic (CCalculation.cpp:772-775)."""
    return torch.diff(result_z, dim=0)
