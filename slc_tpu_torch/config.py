"""Configuration dataclasses.

The reference hides all of this in compile-time ``extern const`` globals
(DynaFrame/StaticParameters.cpp:1-38); changing anything required a
recompile. Here a single frozen dataclass travels through the functional
pipeline as a static (hashable) jit argument.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static system configuration (hashable; safe as a jit static arg).

    Defaults replicate the reference constants
    (DynaFrame/StaticParameters.cpp:4-38).
    """

    # Camera / projector resolutions (rows, cols).
    cam_h: int = 1024          # CAMERA_RESROW   (StaticParameters.cpp:9)
    cam_w: int = 1280          # CAMERA_RESLINE  (StaticParameters.cpp:8)
    pro_h: int = 800           # PROJECTOR_RESROW  (StaticParameters.cpp:5)
    pro_w: int = 1280          # PROJECTOR_RESLINE (StaticParameters.cpp:4)

    # Pattern budget.
    gray_bits: int = 6         # GRAY_V_NUMDIGIT (StaticParameters.cpp:16)
    phase_steps: int = 4       # PHASE_NUMDIGIT  (StaticParameters.cpp:18)

    # Depth validity window, scene units (StaticParameters.cpp:34-35).
    fov_min: float = 10.0
    fov_max: float = 100.0

    # Stripe-tracking window (StaticParameters.cpp:38). Must be odd.
    reco_window: int = 21

    # Number of frames in a dynamic sequence (StaticParameters.cpp:31).
    max_frames: int = 100

    # ------------------------------------------------------------------
    # Derived quantities (property, so the dataclass stays hashable).
    # ------------------------------------------------------------------
    @property
    def gray_levels(self) -> int:
        """Number of Gray-code bins = 2**bits (CDecodeGray.cpp:44)."""
        return 1 << self.gray_bits

    @property
    def gray_period(self) -> float:
        """Projector columns per Gray bin (CDecodeGray.cpp:183)."""
        return self.pro_w / self.gray_levels

    @property
    def phase_period(self) -> int:
        """Fringe period in projector px: PRO_W / 2**(bits-1)
        (CCalculation.cpp:550). Twice the Gray period, so each fringe
        spans two Gray bins."""
        return self.pro_w // (1 << (self.gray_bits - 1))

    @property
    def track_radius(self) -> int:
        """Half-width of the extremum search window (CCalculation.cpp:837)."""
        return self.reco_window // 2

    def with_resolution(self, cam_h: int, cam_w: int) -> "SystemConfig":
        return dataclasses.replace(self, cam_h=cam_h, cam_w=cam_w)


#: Exact reference configuration (StaticParameters.cpp).
REFERENCE_CONFIG = SystemConfig()

#: Small config for fast tests (BASELINE config 1 resolution).
TEST_CONFIG = SystemConfig(cam_h=480, cam_w=640, pro_h=480, pro_w=640,
                           gray_bits=5, phase_steps=4, max_frames=8)


@dataclasses.dataclass(frozen=True)
class HeterodyneConfig:
    """Multi-frequency heterodyne unwrapping spec (BASELINE config 2;
    absent in the reference, which uses Gray-assisted unwrap instead).

    Frequencies are specified as integer *fringe counts* across the
    projector width (finest first); the fringe period for projector
    width W is ``W / count``. Counts whose successive differences
    cascade down to exactly 1 (e.g. 64, 59, 55 -> beats 5, 4 -> 1)
    give a synthetic beat period of exactly W for *any* W, so the
    default is valid at every resolution.
    """

    fringe_counts: Tuple[int, ...] = (64, 59, 55)
    phase_steps: int = 4

    def periods(self, pro_w: float) -> Tuple[float, ...]:
        """Fringe periods in projector px for width ``pro_w``."""
        return tuple(pro_w / n for n in self.fringe_counts)

    @property
    def num_images(self) -> int:
        return len(self.fringe_counts) * self.phase_steps

    @staticmethod
    def beat_period(p1: float, p2: float) -> float:
        return p1 * p2 / abs(p2 - p1)
