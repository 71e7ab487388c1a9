"""Spatial filters: the 3x3 box blur and the bilateral depth filter
(PyTorch port of slc_tpu/ops/filters.py).

The 3x3 blur replicates ``cv::blur(src, dst, Size(3,3))`` applied to the
delta-P map in the reference (DynaFrame/CCalculation.cpp:648-650),
including OpenCV's default BORDER_REFLECT_101 border.

The bilateral filter reproduces the reference's depth post-filter
``bilateralFilter(d=3, sigmaColor=10, sigmaSpace=25)``
(DynaFrame/depthMapUtils.cpp:179) as a stencil, with a hole-aware weight
so invalid (z == 0) pixels neither bleed nor get filled.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def box_blur(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Separable mean filter with REFLECT_101 borders (cv::blur
    defaults), rows then columns. Each pass adds the ``size`` shifted
    taps directly: slc_tpu takes differences of cumulative sums, which
    in float32 lose ~1e-4 px across a 1280-column row."""
    r = size // 2
    h, w = x.shape
    pad = F.pad(x[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    x = sum(pad[i:i + h] for i in range(size))
    pad = F.pad(x[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    x = sum(pad[:, i:i + w] for i in range(size))
    return x / float(size * size)


box_blur_3x3 = functools.partial(box_blur, size=3)


def bilateral_constants(sigma_color: float, sigma_space: float):
    """The two exponent scales, -1/(2 sigma^2), rounded to float32 as
    slc_tpu rounds them (filters.py:81-82)."""
    return (float(np.float32(-0.5 / (sigma_color * sigma_color))),
            float(np.float32(-0.5 / (sigma_space * sigma_space))))


def bilateral_filter(img: torch.Tensor, radius: int = 1,
                     sigma_color: float = 10.0, sigma_space: float = 25.0,
                     hole_aware: bool = True) -> torch.Tensor:
    """Brute-force bilateral filter over a (2r+1)^2 stencil: the plain
    version of the kernel in slc_tpu_torch.kernels.bilateral.

    Parameterised as the reference call (depthMapUtils.cpp:179: d=3 ->
    radius 1, sigmaColor=10, sigmaSpace=25). With ``hole_aware``, pixels
    where img == 0 are missing: they get zero weight and stay zero.
    Out-of-image neighbours are missing too: these are the border
    semantics slc_tpu's TPU kernel runs (pallas/bilateral.py:9-15). Its
    XLA path wraps around instead (ops/filters.py:89-96); the two agree
    on every pixel at least ``radius`` px inside the border."""
    r = radius
    h, w = img.shape
    x = img.float()
    inv2sc, inv2ss = bilateral_constants(sigma_color, sigma_space)
    valid = x != 0 if hole_aware else torch.ones_like(x, dtype=torch.bool)
    xp = F.pad(x, (r, r, r, r))
    okp = F.pad(valid.float(), (r, r, r, r))
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            v = xp[r + dy:r + dy + h, r + dx:r + dx + w]
            space = float(np.float32(dy * dy + dx * dx) * np.float32(inv2ss))
            wt = torch.exp((v - x) * (v - x) * inv2sc + space)
            wt = wt * okp[r + dy:r + dy + h, r + dx:r + dx + w]
            num = num + wt * v
            den = den + wt
    out = num / torch.clamp(den, min=1e-12)
    if hole_aware:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out
