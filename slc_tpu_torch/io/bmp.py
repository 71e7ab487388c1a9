"""BMP image codec (8-bit grayscale and 24-bit BGR).

The reference's datasets are 8-bit BMPs read with ``cv::imread(...,
CV_LOAD_IMAGE_GRAYSCALE)`` (DynaFrame/CSensorV.cpp:111-114). This module
gives the framework a codec for the same files, as slc_tpu/io/bmp.py does:
grayscale reads and writes go through the native C++ codec
(slc_tpu_torch/io/native, built from source at first use; a failed build
raises), and a file the native codec returns an error code for goes to
the numpy codec here (``_read_bmp_numpy``), which reads or rejects it.
Colour reads and writes take the numpy codec. The pixels read and the
bytes written are slc_tpu's.
"""

from __future__ import annotations

import struct

import numpy as np

from slc_tpu_torch.io import native

_BF_HEADER = struct.Struct("<2sIHHI")          # BITMAPFILEHEADER
_BI_HEADER = struct.Struct("<IiiHHIIiiII")     # BITMAPINFOHEADER


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as an 8-bit palette BMP or (H, W, 3) uint8
    (RGB order) as a 24-bit BMP. Grayscale writes take the native codec;
    where it fails to write, the numpy codec writes (or raises)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("BMP writer expects uint8")
    if img.ndim == 2 and native.write_gray(path, img):
        return
    _write_bmp_numpy(path, img)


def _write_bmp_numpy(path: str, img: np.ndarray) -> None:
    """The numpy BMP writer (uint8 ``img``, as ``write_bmp`` takes)."""
    h, w = img.shape[:2]
    gray = img.ndim == 2
    bpp = 8 if gray else 24
    row_bytes = (w * bpp // 8 + 3) & ~3
    palette = b"".join(struct.pack("<BBBB", i, i, i, 0)
                       for i in range(256)) if gray else b""
    data_offset = _BF_HEADER.size + _BI_HEADER.size + len(palette)
    img_size = row_bytes * h

    rows = np.zeros((h, row_bytes), np.uint8)
    if gray:
        rows[:, :w] = img[::-1]                       # bottom-up
    else:
        rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # RGB->BGR

    with open(path, "wb") as f:
        f.write(_BF_HEADER.pack(b"BM", data_offset + img_size, 0, 0,
                                data_offset))
        f.write(_BI_HEADER.pack(_BI_HEADER.size, w, h, 1, bpp, 0,
                                img_size, 2835, 2835,
                                256 if gray else 0, 0))
        f.write(palette)
        f.write(rows.tobytes())


def read_bmp(path: str, grayscale: bool = True) -> np.ndarray:
    """Read an uncompressed 8-bit palette or 24/32-bit BMP. With
    ``grayscale`` (the reference's imread mode, CSensorV.cpp:111-114),
    color images are converted with the OpenCV/ITU-R 601 weights.
    Grayscale reads take the native codec; a file it returns an error
    code for goes to the numpy codec, which reads or rejects it."""
    if grayscale:
        out = native.read_gray(path)
        if out is not None:
            return out
    return _read_bmp_numpy(path, grayscale)


def _read_bmp_numpy(path: str, grayscale: bool = True) -> np.ndarray:
    """The numpy BMP reader: ``read_bmp`` without the native codec."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _, _, _, data_offset = _BF_HEADER.unpack_from(buf, 0)
    if magic != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (hdr_size, w, h, _, bpp, compression, _, _, _, clr_used,
     _) = _BI_HEADER.unpack_from(buf, _BF_HEADER.size)
    if compression != 0:
        raise ValueError(f"{path}: compressed BMP not supported")
    flip = h > 0
    h = abs(h)
    row_bytes = (w * bpp // 8 + 3) & ~3
    raw = np.frombuffer(buf, np.uint8, row_bytes * h, data_offset)
    rows = raw.reshape(h, row_bytes)
    if flip:
        rows = rows[::-1]

    if bpp == 8:
        n_pal = clr_used or 256
        pal = np.frombuffer(buf, np.uint8, n_pal * 4,
                            _BF_HEADER.size + hdr_size).reshape(n_pal, 4)
        idx = rows[:, :w]
        bgr = pal[idx, :3]                            # (H, W, 3) B,G,R
    elif bpp in (24, 32):
        c = bpp // 8
        bgr = rows[:, :w * c].reshape(h, w, c)[:, :, :3]
    else:
        raise ValueError(f"{path}: {bpp}-bit BMP not supported")

    if grayscale:
        if bpp == 8 and (pal[:, 0] == pal[:, 1]).all() \
                and (pal[:, 1] == pal[:, 2]).all():
            return bgr[..., 0].copy()                 # true grayscale
        b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
        # OpenCV's exact integer BGR2GRAY arithmetic (also the native
        # codec's): (1868 B + 9617 G + 4899 R + 8192) >> 14.
        return ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14
                ).astype(np.uint8)
    return bgr[..., ::-1].copy()                      # RGB
