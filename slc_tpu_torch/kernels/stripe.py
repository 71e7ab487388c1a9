"""Stripe regression: per-pixel offsets of the bright and dark stripes.

Source note. Replaces slc_tpu/pallas/stripe.py:102
``stripe_regression_pallas``. The CUDA kernel (csrc/stripe.cu) works on
2-D tiles: the u8 tile and its halo (r rows above and below, r+1 columns
left, r right) become window-row integer box sums in shared memory once,
and each thread scans its pixels' offsets [-r, r) there with strict
comparisons from the center: the reference tie-break, exactly. On the card
it is bound by device memory: one u8 read and two f32 writes, 9 B/px; the
halo re-reads hit the caches.

``stripe_regression`` dispatches on the device of the frame: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops.stripe import box_sum_vertical, windowed_extrema

Strips = Tuple[torch.Tensor, torch.Tensor]


def check_window(window: int) -> None:
    """The kernels take odd windows of 5..63 px: r >= 2 keeps the
    carried strips zero two pixels deep, which the dynamic step's
    border handling relies on, and r <= 31 bounds shared memory."""
    if window % 2 == 0 or not 5 <= window <= 63:
        raise ValueError(f"window must be odd in [5, 63], got {window}")


def stripe_regression_ref(frame: torch.Tensor, window: int = 21,
                          subpixel: bool = True) -> Strips:
    """Plain PyTorch version: box sum -> windowed extrema
    (slc_tpu/ops/stripe.py:151-158). Returns (strip_w, strip_b)."""
    return windowed_extrema(box_sum_vertical(frame, window), window,
                            subpixel)


def stripe_regression_cuda(frame: torch.Tensor, window: int = 21,
                           subpixel: bool = True) -> Strips:
    """The hand-written kernel: ``frame`` is a contiguous (H, W) u8
    CUDA tensor."""
    check_window(window)
    dev = frame.device
    if frame.ndim != 2 or frame.numel() == 0:
        raise ValueError(f"frame: expected a non-empty (H, W) tensor, got "
                         f"{tuple(frame.shape)}")
    h, w = frame.shape
    _build.require(frame, "frame", torch.uint8, (h, w), dev)
    sw = torch.empty((h, w), dtype=torch.float32, device=dev)
    sb = torch.empty((h, w), dtype=torch.float32, device=dev)
    err = _build.lib().slc_stripe(frame.data_ptr(), sw.data_ptr(),
                                  sb.data_ptr(), h, w, window,
                                  int(subpixel), _build.stream_of(dev))
    stripe_regression_cuda.launches += 1
    _build.check(err, "slc_stripe")
    return sw, sb


stripe_regression_cuda.launches = 0


def stripe_regression(frame: torch.Tensor, window: int = 21,
                      subpixel: bool = True) -> Strips:
    """Raw (H, W) camera frame -> (strip_w, strip_b) float32 offsets
    (CCalculation::StripRegression, CCalculation.cpp:789-891)."""
    if frame.device.type == "cpu":
        return stripe_regression_ref(frame, window, subpixel)
    return stripe_regression_cuda(frame, window, subpixel)
