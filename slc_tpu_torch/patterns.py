"""Projector pattern generation and continuous pattern models.

The reference ships pre-captured BMPs and a Gray LUT text file
(DynaFrame/Patterns/vGrayCode.txt); patterns themselves are generated
offline and absent from the repo. This module defines the pattern family
analytically, both as

* discrete projector images (for a live/simulated projector and for
  writing replay datasets), and
* continuous functions of the projector coordinate x (for rendering
  synthetic camera views at sub-pixel correspondence).

Conventions:
* Gray patterns: bin(x) = floor(x / period), period = pro_w / 2**bits
  (CDecodeGray.cpp:183); image k carries bit k (LSB-first, matching the
  assembly ``grayCode += 1 << binIdx``, CDecodeGray.cpp:197) of
  gray = bin ^ (bin >> 1); each pattern is followed by its inverse
  (CDecodeGray.cpp:159: the decoder differences image pairs 2k, 2k+1).
* Fringe patterns: I_k(x) = (sin(2*pi*(x - 0.5)/T + k*2*pi/N) + 1) * 127,
  the model documented at CDecodePhase.cpp:59-62. The -0.5 px phase
  origin exactly cancels the decoder's +0.5 px convention
  (CDecodePhase.cpp:70), so decode(I(x)) == x mod T.
"""

from __future__ import annotations

import numpy as np


def gray_bin(x: np.ndarray, period: float) -> np.ndarray:
    """Continuous projector coord -> integer Gray bin index."""
    return np.floor(np.asarray(x, np.float64) / period).astype(np.int64)


def gray_bit_at(x: np.ndarray, bit: int, period: float) -> np.ndarray:
    """Value (0/1) of Gray bit ``bit`` at continuous coordinate x."""
    b = gray_bin(x, period)
    g = b ^ (b >> 1)
    return ((g >> bit) & 1).astype(np.uint8)


def fringe_at(x: np.ndarray, step: int, num_steps: int,
              period: float) -> np.ndarray:
    """Continuous fringe intensity in [0, 254] at coordinate x."""
    phi = 2.0 * np.pi * (np.asarray(x, np.float64) - 0.5) / period
    return (np.sin(phi + step * 2.0 * np.pi / num_steps) + 1.0) * 127.0


def gray_pattern_images(pro_w: int, pro_h: int, bits: int) -> np.ndarray:
    """(2*bits, pro_h, pro_w) uint8 vertical Gray pattern/inverse pairs."""
    period = pro_w / (1 << bits)
    x = np.arange(pro_w, dtype=np.float64)
    out = np.empty((2 * bits, pro_h, pro_w), np.uint8)
    for k in range(bits):
        row = gray_bit_at(x, k, period) * np.uint8(255)
        out[2 * k] = np.broadcast_to(row, (pro_h, pro_w))
        out[2 * k + 1] = 255 - out[2 * k]
    return out


def phase_pattern_images(pro_w: int, pro_h: int, period: float,
                         num_steps: int) -> np.ndarray:
    """(N, pro_h, pro_w) uint8 vertical fringe images."""
    x = np.arange(pro_w, dtype=np.float64)
    out = np.empty((num_steps, pro_h, pro_w), np.uint8)
    for k in range(num_steps):
        row = np.round(fringe_at(x, k, num_steps, period))
        out[k] = np.broadcast_to(row.astype(np.uint8), (pro_h, pro_w))
    return out


def stripe_pattern(pro_w: int, pro_h: int, period: int = 20) -> np.ndarray:
    """Sinusoidal stripe pattern for dynamic frames — the single per-frame
    pattern whose extrema the dynamic tracker follows
    (CCalculation.cpp:789-891).

    The period is matched to the tracking window (RECO_WINDOW_SIZE = 21,
    StaticParameters.cpp:38) so every 21-px window contains exactly one
    bright and one dark extremum, 10 px apart — which is what makes the
    reference's min(|dW|, |dB|) stripe-family selection
    (CCalculation.cpp:603-618) robust when one extremum crosses the window
    edge. A flat square wave is degenerate for this tracker: the box-sum
    ties everywhere within a stripe and the strict-inequality tie-breaking
    collapses every offset to the window center."""
    x = np.arange(pro_w, dtype=np.float64)
    row = np.round(stripe_at(x, period)).astype(np.uint8)
    return np.broadcast_to(row, (pro_h, pro_w)).copy()


def stripe_at(x: np.ndarray, period: int = 20) -> np.ndarray:
    """Continuous intensity of :func:`stripe_pattern` in [0, 254]."""
    phi = 2.0 * np.pi * np.asarray(x, np.float64) / period
    return (np.cos(phi) + 1.0) * 127.0


def gray_lut_table(bits: int) -> np.ndarray:
    """(2**bits, 2) array of (binary, gray) pairs — the generated
    replacement for Patterns/vGrayCode.txt (vGrayCode.txt:1-64)."""
    b = np.arange(1 << bits, dtype=np.int64)
    return np.stack([b, b ^ (b >> 1)], axis=1)


def write_gray_lut(path: str, bits: int) -> None:
    """Write the (binary, gray) LUT in the reference's text format
    (Patterns/vGrayCode.txt:1-64: one "binary gray" pair per line) so
    generated patterns interoperate with reference tooling."""
    with open(path, "w") as f:
        for b, g in gray_lut_table(bits):
            f.write(f"{b} {g}\n")
