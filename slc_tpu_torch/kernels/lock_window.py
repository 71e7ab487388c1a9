"""The two middle values of |dP/du| over a frame-0 absolute map
(csrc/lock_window.cu), for the tracker's lock window.

Source note. Not a port of a TPU kernel: slc_tpu takes this median with
numpy on the host (slc_tpu/ops/demod.py:297-314
``suggest_lock_window``), and the port did too, ~30 ms a sequence at
1024x1280 with the card idle. The kernel keeps the map on the card: an
exact radix select of the float64 |g| by their bit patterns, six passes
over the map (L2-resident after the first), each one launch whose last
block picks the next digit, so the host reads back only n and the two
middle values. Bound by those passes' reads of the map and their
launches.

``middle_abs_gradients`` dispatches on its input: a CUDA tensor takes the
kernel, anything else the plain numpy version.
"""

from __future__ import annotations

import numpy as np
import torch

from slc_tpu_torch.kernels import _build


def valid_abs_gradients(pu) -> np.ndarray:
    """|g| of the valid interior pixels of the map ``pu``, in float64:
    g = 0.5 * (P[v, u+1] - P[v, u-1]), valid where P > 0 and |g| > 1e-3
    (slc_tpu/ops/demod.py:307-310)."""
    pu = np.asarray(pu, np.float64)
    g = 0.5 * (np.roll(pu, -1, axis=1) - np.roll(pu, 1, axis=1))
    g = g[1:-1, 1:-1]
    valid = (pu[1:-1, 1:-1] > 0) & (np.abs(g) > 1e-3)
    return np.abs(g[valid])


def middle_abs_gradients_ref(pu) -> tuple:
    """Plain numpy version: (n, a, b), the count of valid interior pixels
    of the (H, W) map ``pu`` and the order statistics (n-1)//2 and n//2 of
    their |g| (0.0 and 0.0 when n is 0)."""
    a = valid_abs_gradients(pu)
    n = a.size
    if n == 0:
        return 0, 0.0, 0.0
    lo, hi = (n - 1) // 2, n // 2
    part = np.partition(a, (lo, hi))
    return n, float(part[lo]), float(part[hi])


def middle_abs_gradients_cuda(pu: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel, launches only (no wait, capturable):
    ``pu`` is a contiguous (H, W) f32 CUDA tensor; returns a (3,) int64
    tensor on its device: n, then the float64 bits of the two middle
    values."""
    if pu.ndim != 2 or pu.numel() == 0:
        raise ValueError(f"pu: expected a non-empty (H, W) tensor, got "
                         f"{tuple(pu.shape)}")
    h, w = pu.shape
    if h * w >= 1 << 30:
        raise ValueError(f"pu: {h}x{w} is too large for the kernel's int "
                         f"indices (under 2^30 pixels)")
    dev = pu.device
    _build.require(pu, "pu", torch.float32, (h, w), dev)
    out = torch.empty(3, dtype=torch.int64, device=dev)
    work = torch.empty(_build.lib().slc_lock_window_work_bytes(),
                       dtype=torch.uint8, device=dev)
    _build.launch("slc_lock_window", dev, pu.data_ptr(), h, w,
                  work.data_ptr(), out.data_ptr())
    middle_abs_gradients_cuda.launches += 1
    return out


middle_abs_gradients_cuda.launches = 0


def middle_abs_gradients(pu) -> tuple:
    """(n, a, b) as :func:`middle_abs_gradients_ref` gives them: a CUDA
    tensor through the kernel, its 24 bytes read back into pinned memory
    after one wait on its stream; anything else by the plain version."""
    if not (isinstance(pu, torch.Tensor) and pu.device.type == "cuda"):
        return middle_abs_gradients_ref(pu)
    got = middle_abs_gradients_cuda(pu.contiguous())
    host = torch.empty(3, dtype=torch.int64, pin_memory=True)
    host.copy_(got, non_blocking=True)
    torch.cuda.current_stream(got.device).synchronize()
    vals = host.numpy()
    n = int(vals[0])
    if n == 0:
        return 0, 0.0, 0.0
    a, b = vals[1:].view(np.float64)
    return n, float(a), float(b)
