"""Spatial filters: the 3x3 box blur (PyTorch port of
slc_tpu/ops/filters.py:22-37; the bilateral filter is not ported yet).

The 3x3 blur replicates ``cv::blur(src, dst, Size(3,3))`` applied to the
delta-P map in the reference (DynaFrame/CCalculation.cpp:648-650),
including OpenCV's default BORDER_REFLECT_101 border.
"""

from __future__ import annotations

import functools

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
