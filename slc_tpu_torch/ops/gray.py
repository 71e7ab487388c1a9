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


def gray_to_binary(g: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse Gray map via XOR prefix-scan: log2(num_bits) steps."""
    b = g
    shift = 1
    while shift < num_bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def decode_gray(images: torch.Tensor, num_bits: int,
                projector_extent: int) -> torch.Tensor:
    """(2N, H, W) uint8 -> (H, W) float32 absolute projector coordinate
    ``bin * period`` (CDecodeGray.cpp:179-204). u8 planes are compared,
    never subtracted, so no widening is needed here."""
    gray = torch.zeros(images.shape[1:], dtype=torch.int32,
                       device=images.device)
    for k in range(num_bits):
        bit = images[2 * k] > images[2 * k + 1]
        gray = gray | (bit.to(torch.int32) << k)
    binary = gray_to_binary(gray, num_bits)
    period = projector_extent / (1 << num_bits)
    return binary.float() * period
