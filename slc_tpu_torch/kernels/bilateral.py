"""Hole-aware bilateral depth filter (the spatial decode's last stage).

Source note. Replaces slc_tpu/pallas/bilateral.py:61
``bilateral_filter_pallas``. It moves one f32 read and one f32 write, 8
B/px, but nine exponentials, nine hole tests and an IEEE division a pixel
put it nearer the card's issue rate, so the CUDA kernel
(csrc/bilateral.cu) cuts instructions: each edge weight is computed once
and taken by both pixels it joins (4 expf a pixel, not 9; bit for bit the
same weights), a warp walks a strip of rows of a 128-column tile with a
lane's 4 columns and a rolling 3-row window in registers (float4 loads and
stores, neighbours' columns by shuffle, no shared memory). Out-of-image
neighbours count as missing, in the kernel and in its plain version
(ops.filters.bilateral_filter): the border semantics of the TPU kernel,
where slc_tpu's XLA path wraps.

``bilateral_filter`` dispatches on the device of its input: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops import filters


def bilateral_filter_ref(img: torch.Tensor, sigma_color: float = 10.0,
                         sigma_space: float = 25.0) -> torch.Tensor:
    """Plain PyTorch version: ops.filters.bilateral_filter, radius 1,
    hole-aware."""
    return filters.bilateral_filter(img, 1, sigma_color, sigma_space,
                                    hole_aware=True)


def bilateral_filter_cuda(img: torch.Tensor, sigma_color: float = 10.0,
                          sigma_space: float = 25.0) -> torch.Tensor:
    """The hand-written kernel: ``img`` is a contiguous (H, W) f32 CUDA
    tensor; returns a new (H, W) f32 map. The host work before the
    launch is the span ``kernel.prep``."""
    if img.ndim != 2 or img.numel() == 0:
        raise ValueError(f"img: expected a non-empty (H, W) tensor, got "
                         f"{tuple(img.shape)}")
    dev = img.device
    h, w = img.shape
    with metrics.span("kernel.prep"):
        _build.require(img, "img", torch.float32, (h, w), dev)
        out = torch.empty((h, w), dtype=torch.float32, device=dev)
        inv2sc, inv2ss = filters.bilateral_constants(sigma_color,
                                                     sigma_space)
    _build.launch("slc_bilateral", dev, img.data_ptr(), out.data_ptr(), h,
                  w, inv2sc, inv2ss)
    bilateral_filter_cuda.launches += 1
    return out


bilateral_filter_cuda.launches = 0


def bilateral_filter(img: torch.Tensor, radius: int = 1,
                     sigma_color: float = 10.0, sigma_space: float = 25.0,
                     hole_aware: bool = True) -> torch.Tensor:
    """Bilateral depth filter (depthMapUtils.cpp:179): CPU tensors take
    the plain version, anything else the kernel, which implements only
    the hole-aware 3x3 form and raises for any other."""
    if img.device.type == "cpu":
        return filters.bilateral_filter(img, radius, sigma_color,
                                        sigma_space, hole_aware)
    if radius != 1 or not hole_aware:
        raise ValueError(
            "the bilateral kernel implements only the hole-aware 3x3 "
            "filter (radius=1, hole_aware=True)")
    return bilateral_filter_cuda(img, sigma_color, sigma_space)
