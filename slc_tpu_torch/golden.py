"""Float64 NumPy golden oracle (a copy of slc_tpu/golden.py, so that the
port's tests and its card host, which has no jax, have it).

An independent, scalar-faithful re-implementation of the pipeline math in
host float64, used by the test-suite to (a) cross-check the vectorized
torch path and the CUDA kernels against a second implementation and (b)
bound the float32 precision loss of the device path. Each function
documents the reference behavior it models (file:line into the reference
C++ sources).

This module intentionally contains no torch and no JAX: plain numpy
only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ----------------------------------------------------------------------
# Decoders
# ----------------------------------------------------------------------

def decode_phase(images: np.ndarray, period: float) -> np.ndarray:
    """4+-step phase decode (CDecodePhase.cpp:48-80), exact atan2."""
    n = images.shape[0]
    imgs = images.astype(np.float64)
    k = np.arange(n) * (2.0 * np.pi / n)
    sin_t = np.tensordot(np.cos(k), imgs, axes=(0, 0)) * (2.0 / n)
    cos_t = np.tensordot(np.sin(k), imgs, axes=(0, 0)) * (2.0 / n)
    ang = np.degrees(np.arctan2(sin_t, cos_t))
    ang = np.where(ang < 0, ang + 360.0, ang)
    pix = ang / 360.0 * period + 0.5          # CDecodePhase.cpp:69-70
    return np.where(pix > period, pix - period, pix)


def decode_gray(images: np.ndarray, num_bits: int,
                projector_extent: int) -> np.ndarray:
    """Gray decode via the explicit LUT route the reference takes
    (CDecodeGray.cpp:108-204), to independently validate the XOR-prefix
    closed form used on device."""
    lut = np.zeros(1 << num_bits, np.int64)
    for b in range(1 << num_bits):
        lut[b ^ (b >> 1)] = b                  # bin -> gray inverted
    gray = np.zeros(images.shape[1:], np.int64)
    for k in range(num_bits):
        bit = images[2 * k].astype(np.int32) > images[2 * k + 1].astype(np.int32)
        gray += bit.astype(np.int64) << k      # CDecodeGray.cpp:192-199
    period = projector_extent / (1 << num_bits)
    return lut[gray].astype(np.float64) * period


def gray_assisted_merge(gray_coord: np.ndarray, phase: np.ndarray,
                        gray_period: float, phase_period: float
                        ) -> np.ndarray:
    """Scalar-faithful merge (CCalculation.cpp:561-587)."""
    t = float(phase_period)
    ph = phase.copy()
    bin_idx = (gray_coord / gray_period).astype(np.int64)
    even = (bin_idx % 2) == 0
    ph = np.where(even & (ph > 0.75 * t), ph - t, ph)
    odd_ph = np.where(ph < 0.25 * t, ph + t, ph) - 0.5 * t
    ph = np.where(even, ph, odd_ph)
    return gray_coord + ph


# ----------------------------------------------------------------------
# Triangulation
# ----------------------------------------------------------------------

def triangulation_tables(cam_k: np.ndarray, pro_mat: np.ndarray,
                         cam_h: int, cam_w: int):
    """Unnormalized f64 tables exactly as the reference builds them
    (CCalculation.cpp:135-166)."""
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]
    a = fx * fy * pro_mat[0, 3]
    b = fx * fy * pro_mat[2, 3]
    u = np.arange(cam_w, dtype=np.float64)[None, :] - cx
    v = np.arange(cam_h, dtype=np.float64)[:, None] - cy
    c = u * fy * pro_mat[0, 0] + v * fx * pro_mat[0, 1] + fx * fy * pro_mat[0, 2]
    d = u * fy * pro_mat[2, 0] + v * fx * pro_mat[2, 1] + fx * fy * pro_mat[2, 2]
    return a, b, np.broadcast_to(c, (cam_h, cam_w)), np.broadcast_to(d, (cam_h, cam_w))


def triangulate(proj_u: np.ndarray, cam_k: np.ndarray, pro_mat: np.ndarray,
                fov_min: float, fov_max: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """z = -(A - B P)/(C - D P), FOV clamp, back-projection
    (CCalculation.cpp:666-771); holes (P == 0) give z = 0."""
    h, w = proj_u.shape
    a, b, c, d = triangulation_tables(cam_k, pro_mat, h, w)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = -(a - b * proj_u) / (c - d * proj_u)
    z = np.where(proj_u == 0, 0.0, z)
    z = np.where((z < fov_min) | (z > fov_max), 0.0, z)
    u = np.arange(w, dtype=np.float64)[None, :] - cam_k[0, 2]
    v = np.arange(h, dtype=np.float64)[:, None] - cam_k[1, 2]
    x = z * u / cam_k[0, 0]
    y = z * v / cam_k[1, 1]
    return x, y, z


# ----------------------------------------------------------------------
# Dynamic tracking
# ----------------------------------------------------------------------

def box_sum_vertical(frame: np.ndarray, window: int) -> np.ndarray:
    """Literal rolling-DP transcription (CCalculation.cpp:797-823)."""
    r = window // 2
    h, w = frame.shape
    cam = frame.astype(np.float64)
    vs = np.zeros((h, w))
    for col in range(r, w - r):
        vs[r, col] = cam[0:window, col].sum()
    for row in range(r + 1, h - r):
        vs[row, r:w - r] = (vs[row - 1, r:w - r]
                            - cam[row - r - 1, r:w - r]
                            + cam[row + r, r:w - r])
    return vs


def windowed_extrema(vs: np.ndarray, window: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Literal scan transcription (CCalculation.cpp:828-891), including
    the strict-inequality/center-initialized tie-breaking."""
    r = window // 2
    h, w = vs.shape
    strip_w = np.zeros((h, w), np.float64)
    strip_b = np.zeros((h, w), np.float64)
    for row in range(r, h - r):
        for col in range(r, w - r):
            vmax = vs[row, col]
            vmin = vs[row, col]
            imax = 0.0
            imin = 0.0
            for i in range(-r, r):
                val = vs[row, col + i]
                if val > vmax:
                    vmax, imax = val, float(i)
                if val < vmin:
                    vmin, imin = val, float(i)
            strip_w[row, col] = imax
            strip_b[row, col] = imin
    return strip_w, strip_b


def box_blur_3x3(x: np.ndarray) -> np.ndarray:
    """cv::blur(Size(3,3)) with BORDER_REFLECT_101 (CCalculation.cpp:650)."""
    p = np.pad(x.astype(np.float64), 1, mode="reflect")
    out = np.zeros_like(x, np.float64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out += p[1 + dy:1 + dy + x.shape[0], 1 + dx:1 + dx + x.shape[1]]
    return out / 9.0


def dynamic_step(proj_u_prev, strip_w_prev, strip_b_prev, frame, window):
    """One golden dynamic frame (CCalculation.cpp:221-242 body, minus
    triangulation): returns (proj_u, strip_w, strip_b, delta_p)."""
    vs = box_sum_vertical(frame, window)
    sw, sb = windowed_extrema(vs, window)
    db = strip_b_prev - sb
    dw = strip_w_prev - sw
    dp = np.where(np.abs(db) < np.abs(dw), db, dw)   # CCalculation.cpp:603-618
    dp = box_blur_3x3(dp)
    return proj_u_prev + dp, sw, sb, dp
