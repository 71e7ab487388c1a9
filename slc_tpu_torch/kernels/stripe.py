"""Stripe regression: per-pixel offsets of the bright and dark stripes.

Source note. Replaces slc_tpu/pallas/stripe.py:102
``stripe_regression_pallas``. The CUDA kernel (csrc/stripe.cu) works on
128x40 tiles: the u8 tile and its halo (r rows above and below, r+1
columns left, r right) are staged in shared memory in 16-byte chunks and
become window-row integer box sums there; each thread then takes four
neighbouring pixels of a row, whose windows share their taps, and finds
each window's extrema from integer keys that carry the offset: the
reference's tie-break (the centre wins a tie, else the leftmost offset),
exactly. It moves 9 B/px (one u8 read, two f32 writes); its bound on the
card is the plain version's 231 operations/px. With ``frac_bits`` > 0
(fast sub-pixel mode) the winner is the exact one and only its parabola
fraction is quantized, the semantics of slc_tpu's packed tournament
without the packing (see :func:`fast_frac_bits`).

``stripe_regression`` dispatches on the device of the frame: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops import stripe as ops_stripe

Strips = Tuple[torch.Tensor, torch.Tensor]


def check_window(window: int) -> None:
    """The kernels take odd windows of 5..63 px: r >= 2 keeps the
    carried strips zero two pixels deep, which the dynamic step's
    border handling relies on, and r <= 31 bounds shared memory."""
    if window % 2 == 0 or not 5 <= window <= 63:
        raise ValueError(f"window must be odd in [5, 63], got {window}")


def fast_frac_bits(frac_bits: int, window: int, lanes: int,
                   subpixel: bool = True) -> int:
    """Fraction bits the fast sub-pixel mode keeps: slc_tpu packs a
    quantized fraction below a box-sum value field of ``vbits`` and a
    column field of ``cbits`` in one int32, so it keeps
    min(frac_bits, 31 - vbits - cbits), and none (the exact fraction)
    when that is below 4, the fields overflow, or ``subpixel`` is off
    (slc_tpu/pallas/mathx.py:296-315). ``lanes`` is the width the TPU
    kernel pads a row to before rounding up to 128: the image width, or
    width + 2*win_u in the locked step (pallas/dynamic_lock.py:325)."""
    if frac_bits < 0:
        raise ValueError(f"frac_bits must be >= 0, got {frac_bits}")
    if not (subpixel and frac_bits) or window < 3:
        return 0
    cbits = (-(-lanes // 128) * 128 - 1).bit_length()
    vbits = (255 * window + 1).bit_length()
    if vbits + cbits > 31:
        return 0
    fbits = min(int(frac_bits), 31 - vbits - cbits)
    return fbits if fbits >= 4 else 0


def stripe_regression_ref(frame: torch.Tensor, window: int = 21,
                          subpixel: bool = True,
                          frac_bits: int = 0) -> Strips:
    """Plain PyTorch version: box sum -> windowed extrema
    (slc_tpu/ops/stripe.py:151-158), with the fraction quantized when
    ``frac_bits`` > 0. Returns (strip_w, strip_b)."""
    fbits = fast_frac_bits(frac_bits, window, frame.shape[-1], subpixel)
    return ops_stripe.stripe_regression(frame, window, subpixel, fbits)


def stripe_regression_cuda(frame: torch.Tensor, window: int = 21,
                           subpixel: bool = True,
                           frac_bits: int = 0) -> Strips:
    """The hand-written kernel: ``frame`` is a contiguous (H, W) u8
    CUDA tensor."""
    check_window(window)
    dev = frame.device
    if frame.ndim != 2 or frame.numel() == 0:
        raise ValueError(f"frame: expected a non-empty (H, W) tensor, got "
                         f"{tuple(frame.shape)}")
    h, w = frame.shape
    fbits = fast_frac_bits(frac_bits, window, w, subpixel)
    _build.require(frame, "frame", torch.uint8, (h, w), dev)
    sw = torch.empty((h, w), dtype=torch.float32, device=dev)
    sb = torch.empty((h, w), dtype=torch.float32, device=dev)
    _build.launch("slc_stripe", dev, frame.data_ptr(), sw.data_ptr(),
                  sb.data_ptr(), h, w, window, int(subpixel), fbits)
    stripe_regression_cuda.launches += 1
    return sw, sb


stripe_regression_cuda.launches = 0


def stripe_regression(frame: torch.Tensor, window: int = 21,
                      subpixel: bool = True, frac_bits: int = 0) -> Strips:
    """Raw (H, W) camera frame -> (strip_w, strip_b) float32 offsets
    (CCalculation::StripRegression, CCalculation.cpp:789-891)."""
    fn = (stripe_regression_ref if frame.device.type == "cpu"
          else stripe_regression_cuda)
    return fn(frame, window, subpixel, frac_bits)
