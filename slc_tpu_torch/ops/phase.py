"""N-step phase-shift fringe decoding (PyTorch port of
slc_tpu/ops/phase.py).

Fringe model (DynaFrame/CDecodePhase.cpp:59-62):
I_k(x) = (sin(phi(x) + k * 2*pi/N) + 1) * 127, k = 0..N-1, so

    sum_k I_k cos(d_k) = (N/2) * B * sin(phi)
    sum_k I_k sin(d_k) = (N/2) * B * cos(phi)

The wrapped result follows the reference pixel convention
(CDecodePhase.cpp:67-74): angle in [0, 2*pi), then
pix = angle/(2*pi) * T + 0.5; pix > T -> pix -= T, a wrapped projector
offset in (0, T].
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def phase_sincos(images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) fringe stack -> (B sin(phi), B cos(phi)), each (H, W)
    float32 (slc_tpu/ops/phase.py:34-48, the same float32 coefficients:
    cos/sin of the float32 step angle)."""
    n = images.shape[0]
    imgs = images.float()
    k = torch.arange(n, dtype=torch.float32, device=images.device) \
        * (2.0 * math.pi / n)
    shape = (n,) + (1,) * (imgs.ndim - 1)
    sin_term = (imgs * torch.cos(k).reshape(shape)).sum(0) * (2.0 / n)
    cos_term = (imgs * torch.sin(k).reshape(shape)).sum(0) * (2.0 / n)
    return sin_term, cos_term


def wrapped_phase_to_pixels(sin_term: torch.Tensor, cos_term: torch.Tensor,
                            period: float) -> torch.Tensor:
    """atan2 -> wrapped projector-px offset in (0, T]
    (CDecodePhase.cpp:67-74)."""
    ang = torch.atan2(sin_term, cos_term)                  # [-pi, pi]
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)   # [0, 2*pi)
    # The scale is rounded as slc_tpu rounds it: a float32 quotient.
    scale = float(np.float32(period) / np.float32(2.0 * math.pi))
    pix = ang * scale + 0.5
    return torch.where(pix > period, pix - period, pix)


def decode_phase(images: torch.Tensor, period: float) -> torch.Tensor:
    """(N, H, W) uint8 -> (H, W) float32 wrapped fringe coordinate in
    (0, T] (CDecodePhase.cpp:48-80)."""
    s, c = phase_sincos(images)
    return wrapped_phase_to_pixels(s, c, period)


def modulation(images: torch.Tensor) -> torch.Tensor:
    """Fringe modulation amplitude B per pixel — the validity signal
    the reference lacks (it relies on P == 0 holes,
    CCalculation.cpp:678-682)."""
    s, c = phase_sincos(images)
    return torch.sqrt(s * s + c * c)
