"""Access-pattern floors: the denominator of "% of measured floor".

Source note. ``halo_block_floor_cuda`` replaces slc_tpu/pallas/floors.py:25
``halo_block_floor``. It reads an (H, W) image in the pattern of a compute
kernel with the compute deleted and writes ``n_out`` full-size float32
maps o_k = float(img) + k, so its device time is the least that pattern
of traffic takes on the card. The pattern follows the dtype, each the
port's own kernel (csrc/floors.cu): a u8 image is read as csrc/stripe.cu
reads the frame (128x32 tiles, ``halo`` rows above and below, ``halo`` + 1
columns left and ``halo`` right, staged in shared memory; 2 outputs make
its 9 B/px), a float32 image as csrc/bilateral.cu reads its map (32x8
tiles with a ``halo``-px ring; 1 output makes its 8 B/px).

``halo_block_floor`` dispatches on the device of the image: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch.kernels import _build

_ENTRY = {torch.uint8: "slc_halo_block_floor_u8",
          torch.float32: "slc_halo_block_floor_f32"}


def _check(img: torch.Tensor, halo: int, n_out: int) -> None:
    if img.dtype not in _ENTRY:
        raise TypeError(f"img: expected uint8 or float32, got {img.dtype}")
    if img.ndim != 2 or img.numel() == 0:
        raise ValueError(f"img: expected a non-empty (H, W) tensor, got "
                         f"{tuple(img.shape)}")
    if not 0 <= halo <= 31:
        raise ValueError(f"halo must be in [0, 31], got {halo}")
    if n_out < 1:
        raise ValueError(f"n_out must be >= 1, got {n_out}")


def halo_block_floor_ref(img: torch.Tensor, halo: int = 10,
                         n_out: int = 2) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the outputs o_k = float(img) + k
    (slc_tpu/pallas/floors.py:59-64); ``halo`` changes only the access
    pattern, not the values."""
    _check(img, halo, n_out)
    x = img.float()
    return tuple(x + float(k) for k in range(n_out))


def halo_block_floor_cuda(img: torch.Tensor, halo: int = 10,
                          n_out: int = 2) -> Tuple[torch.Tensor, ...]:
    """The hand-written floor kernel: ``img`` is a contiguous (H, W) u8
    or float32 CUDA tensor. Returns ``n_out`` (H, W) float32 maps."""
    _check(img, halo, n_out)
    dev = img.device
    h, w = img.shape
    _build.require(img, "img", img.dtype, (h, w), dev)
    out = torch.empty((n_out, h, w), dtype=torch.float32, device=dev)
    _build.launch(_ENTRY[img.dtype], dev, img.data_ptr(), out.data_ptr(),
                  n_out, h, w, halo)
    halo_block_floor_cuda.launches += 1
    return tuple(out.unbind(0))


halo_block_floor_cuda.launches = 0


def halo_block_floor(img: torch.Tensor, halo: int = 10,
                     n_out: int = 2) -> Tuple[torch.Tensor, ...]:
    """(H, W) image -> ``n_out`` float32 maps float(img) + k, read in the
    access pattern of the kernel the dtype stands for."""
    fn = (halo_block_floor_ref if img.device.type == "cpu"
          else halo_block_floor_cuda)
    return fn(img, halo, n_out)
