"""Gray-code decoding (PyTorch port of slc_tpu/ops/gray.py).

N-bit Gray code from 2N images (pattern + inverse per bit): per-bit
binarization ``pattern > inverse`` (DynaFrame/CDecodeGray.cpp:150-176),
LSB-first bit assembly (CDecodeGray.cpp:192-199), the closed-form
XOR-prefix inverse Gray map in place of the reference's LUT file
(CDecodeGray.cpp:113-125), and ``result = bin * period`` with
``period = PRO_W / 2**N`` (CDecodeGray.cpp:200, :183).
"""

from __future__ import annotations

import torch


def binary_to_gray(b: torch.Tensor) -> torch.Tensor:
    """Standard binary -> reflected-Gray map, g = b ^ (b >> 1): the
    correspondence of the reference's Patterns/vGrayCode.txt."""
    return b ^ (b >> 1)


def gray_to_binary(g: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse Gray map via XOR prefix-scan: log2(num_bits) steps."""
    b = g
    shift = 1
    while shift < num_bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def binarize_bits(images: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(2N, H, W) image stack (pattern, inverse alternating) -> (N, H, W)
    bool bit planes: the reference's saturating u8 ``pattern - inverse``
    is > 0 iff ``pattern > inverse`` (CDecodeGray.cpp:159-171)."""
    return images[0:2 * num_bits:2] > images[1:2 * num_bits:2]


def decode_gray_bins(images: torch.Tensor, num_bits: int) -> torch.Tensor:
    """The integer (int32) bin index of each pixel: the binary value of its
    Gray code, bit k from image pair k (LSB first). u8 planes are
    compared, never subtracted, so no widening is needed."""
    gray = torch.zeros(images.shape[1:], dtype=torch.int32,
                       device=images.device)
    for k, bit in enumerate(binarize_bits(images, num_bits)):
        gray = gray | (bit.to(torch.int32) << k)
    return gray_to_binary(gray, num_bits)


def decode_gray(images: torch.Tensor, num_bits: int,
                projector_extent: int) -> torch.Tensor:
    """(2N, H, W) uint8 -> (H, W) float32 absolute projector coordinate
    ``bin * period`` (CDecodeGray.cpp:179-204)."""
    period = projector_extent / (1 << num_bits)
    return decode_gray_bins(images, num_bits).float() * period
