"""Acquisition layer: sensor protocol, simulated rig, capture loop
(a copy of slc_tpu/capture.py over the port's patterns, calib, config
and synth; its own arithmetic is numpy).

The reference has two acquisition paths: the compiled-in simulated
sensor replaying BMPs (CSensorV) and a legacy live pair — projector as
a fullscreen window (DynaFrame/CProjector.cpp:25-30,46-76) plus a
vendor-SDK camera with a 30-retry snapshot loop
(DynaFrame/CCamera.cpp:94-118), driven by the synchronous
project/capture loop sketched (commented out) at main.cpp:50-76.

Here acquisition is a small protocol so the pipeline is source-agnostic:

* :class:`ReplaySensor` — wraps the BMP replay dataset (CSensorV role),
* :class:`SimulatedRig` — closes the loop entirely in software:
  "projecting" a pattern renders the synthetic camera view of the scene
  through the calibrated projector-camera model (the hardware-free
  stand-in for CProjector+CCamera),
* :func:`capture_sequence` — the synchronous project->capture loop.

A real-hardware sensor implements the same protocol against its SDK.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Protocol

import numpy as np

from slc_tpu_torch import patterns
from slc_tpu_torch.calib import Calibration
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.synth import Surface, surface_geometry


class Sensor(Protocol):
    """Minimal acquisition interface (CSensorV.h:37-61 roles)."""

    def project(self, pattern: np.ndarray) -> None:
        """Present a projector pattern (CProjector::presentPicture)."""

    def capture(self) -> np.ndarray:
        """Grab one camera frame (CCamera::getPicture)."""


class ReplaySensor:
    """Replay-dataset sensor: ``project`` selects the next stored frame
    (the SetProPicture/GetCamPicture pairing, CSensorV.cpp:154-179)."""

    def __init__(self, images: np.ndarray):
        self._images = images
        self._idx = -1

    def project(self, pattern: Optional[np.ndarray] = None) -> None:
        self._idx += 1

    def capture(self) -> np.ndarray:
        if not (0 <= self._idx < len(self._images)):
            raise IOError(f"replay index {self._idx} out of range")
        return self._images[self._idx]


class SimulatedRig:
    """Software projector-camera rig: projecting a (pro_h, pro_w)
    pattern and capturing returns the camera view of ``surface`` lit by
    that pattern, sampled at the exact projector correspondence of each
    camera pixel (the slc_tpu_torch.synth model, generalized to arbitrary
    patterns via horizontal lookup)."""

    def __init__(self, calib: Calibration, cfg: SystemConfig,
                 surface: Surface, noise_sigma: float = 0.0,
                 seed: int = 0):
        self.cfg = cfg
        self._rng = (np.random.default_rng(seed)
                     if noise_sigma > 0 else None)
        self.noise_sigma = noise_sigma
        _, self._proj_u = surface_geometry(calib, cfg, surface)
        self._pattern: Optional[np.ndarray] = None

    def project(self, pattern: np.ndarray) -> None:
        self._pattern = np.asarray(pattern)

    def capture(self) -> np.ndarray:
        if self._pattern is None:
            raise IOError("no pattern projected")
        # Vertical patterns: sample the pattern row by projector column
        # (nearest-column, like a DMD's discrete mirrors).
        col = np.clip(np.round(self._proj_u), 0,
                      self.cfg.pro_w - 1).astype(np.int64)
        img = self._pattern[0, :][col].astype(np.float64) \
            if self._pattern.ndim == 2 else self._pattern[col]
        if self._rng is not None:
            img = img + self._rng.normal(0.0, self.noise_sigma, img.shape)
        return np.clip(np.round(img), 0, 255).astype(np.uint8)


def capture_sequence(sensor: Sensor, pats: Iterable[np.ndarray],
                     retries: int = 30) -> List[np.ndarray]:
    """Synchronous project -> capture loop (main.cpp:50-76 sketch), with
    the reference camera's bounded snapshot retry (CCamera.cpp:97-107)."""
    out: List[np.ndarray] = []
    for p in pats:
        sensor.project(p)
        last_err: Optional[Exception] = None
        for _ in range(retries):
            try:
                out.append(sensor.capture())
                break
            except (IOError, OSError) as e:
                last_err = e
        else:
            raise IOError(f"capture failed after {retries} tries: "
                          f"{last_err}")
    return out


def structured_light_patterns(cfg: SystemConfig) -> List[np.ndarray]:
    """The frame-0 pattern budget: 2*bits Gray pattern/inverse pairs
    followed by the N phase-shift fringes (CSensorV.cpp:72,80)."""
    gray = patterns.gray_pattern_images(cfg.pro_w, cfg.pro_h,
                                        cfg.gray_bits)
    phase = patterns.phase_pattern_images(cfg.pro_w, cfg.pro_h,
                                          float(cfg.phase_period),
                                          cfg.phase_steps)
    return [*gray, *phase]
