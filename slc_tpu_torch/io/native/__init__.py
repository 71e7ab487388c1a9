"""Build and load the native host I/O library (``slc_io.cpp``): the BMP
codec, the threaded frame loader and the ASCII point-cloud writer.

The library is compiled by g++ from ``slc_io.cpp`` at first use, never at
import, into ``io/native/build/`` under a name keyed by a hash of the
source and the flags, and loaded through ``ctypes`` (which releases the
interpreter lock around each call). The build writes a temporary file and
``os.replace``s it, so processes that build at once agree on one library.

**A failed build raises** a ``RuntimeError`` carrying g++'s stderr, as a
failed nvcc build of the kernels does: there is no silent fallback to the
numpy codec or to ``np.savetxt``, whose clouds differ from this writer's
in the last digit. ``native=False`` on ``ReplayDataset.frames`` and
``indexed_frames`` is the explicit Python path. A *file* the codec does
not take (an error code from ``slc_bmp_read_gray``) is another matter:
``io/bmp.read_bmp`` hands it to the numpy codec, which reads or rejects
it, as slc_tpu does.

``COUNTS`` counts what went through the library: ``loader_frames``
(frames ``NativeFrameLoader`` delivered), ``bmp_reads`` and
``bmp_writes`` (files the codec read or wrote), ``xyz_writes``
(``slc_write_xyz`` calls that wrote a file). ``reset_counts`` sets them
to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "slc_io.cpp")
_BUILD = os.path.join(_DIR, "build")

#: The library runs only on the host that builds it, so -march=native is
#: safe; a g++ that rejects it builds with FLAGS_PORTABLE instead.
FLAGS = ("-O3", "-march=native", "-pthread", "-shared", "-fPIC")
FLAGS_PORTABLE = ("-O3", "-pthread", "-shared", "-fPIC")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)

_SIGNATURES = {
    "slc_bmp_probe": ([ctypes.c_char_p, _i32p, _i32p, _i32p], ctypes.c_int),
    "slc_bmp_read_gray": ([ctypes.c_char_p, _u8p, ctypes.c_int,
                           ctypes.c_int], ctypes.c_int),
    "slc_bmp_write_gray": ([ctypes.c_char_p, _u8p, ctypes.c_int,
                            ctypes.c_int], ctypes.c_int),
    "slc_write_xyz": ([ctypes.c_char_p, _f32p, _f32p, _f32p, ctypes.c_long],
                      ctypes.c_long),
    "slc_loader_create": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], ctypes.c_void_p),
    "slc_loader_next": ([ctypes.c_void_p, _u8p], ctypes.c_int),
    "slc_loader_destroy": ([ctypes.c_void_p], None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

COUNTS = {"loader_frames": 0, "bmp_reads": 0, "bmp_writes": 0,
          "xyz_writes": 0}
_count_lock = threading.Lock()


def _count(key: str) -> None:
    with _count_lock:
        COUNTS[key] += 1


def reset_counts() -> None:
    with _count_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def library_path() -> str:
    """Where the build of the current source lands."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libslc_io_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if no build of the current source exists;
    return its path. Raises RuntimeError with g++'s stderr on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native I/O library "
                           "(slc_tpu_torch/io/native/slc_io.cpp) cannot be "
                           "built")
    tmp = f"{path}.{os.getpid()}.tmp"
    errors = []
    try:
        for flags in (FLAGS, FLAGS_PORTABLE):
            cmd = [gxx, *flags, _SRC, "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, path)     # atomic: concurrent builders agree
                return path
            errors.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{proc.stderr}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    raise RuntimeError("g++ failed to build the native I/O library:\n"
                       + "\n".join(errors))


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib_ = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib_, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib_
        return _lib


def probe(path: str) -> Optional[tuple]:
    """(h, w, bpp) from an uncompressed BMP's header, or None for a file
    the codec does not take."""
    h, w, bpp = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib().slc_bmp_probe(os.fsencode(path), ctypes.byref(h),
                             ctypes.byref(w), ctypes.byref(bpp))
    return None if rc != 0 else (h.value, w.value, bpp.value)


def read_gray(path: str) -> Optional[np.ndarray]:
    """The BMP at ``path`` as (H, W) uint8 grayscale, or None where the
    codec returns an error code for it."""
    shape = probe(path)
    if shape is None:
        return None
    h, w, _ = shape
    # The codec reads at least a byte a pixel, so a header whose size
    # the file cannot hold is not worth an allocation.
    if h <= 0 or w <= 0 or h * w > os.path.getsize(path):
        return None
    out = np.empty((h, w), np.uint8)
    if lib().slc_bmp_read_gray(os.fsencode(path),
                               out.ctypes.data_as(_u8p), h, w) != 0:
        return None
    _count("bmp_reads")
    return out


def write_gray(path: str, img: np.ndarray) -> bool:
    """Write (H, W) uint8 as an 8-bit palette BMP; False where the codec
    failed to write it."""
    c = np.ascontiguousarray(img, np.uint8)
    if lib().slc_bmp_write_gray(os.fsencode(path), c.ctypes.data_as(_u8p),
                                c.shape[0], c.shape[1]) != 0:
        return False
    _count("bmp_writes")
    return True


def write_xyz(path: str, x: np.ndarray, y: np.ndarray,
              z: np.ndarray) -> int:
    """'x y z' lines, 7 decimals, for the pixels where z > 0; returns the
    number written. Raises IOError naming ``path`` if the writer fails."""
    fx, fy, fz = (np.ascontiguousarray(a, np.float32).ravel()
                  for a in (x, y, z))
    if not fx.size == fy.size == fz.size:
        raise ValueError(f"write_xyz: maps of {fx.size}, {fy.size} and "
                         f"{fz.size} values")
    n = lib().slc_write_xyz(os.fsencode(path), fx.ctypes.data_as(_f32p),
                            fy.ctypes.data_as(_f32p),
                            fz.ctypes.data_as(_f32p), fx.size)
    if n < 0:
        raise IOError(f"slc_write_xyz failed (rc={n}) for {path}")
    _count("xyz_writes")
    return int(n)


class NativeFrameLoader:
    """Ordered iterator over grayscale BMP ``paths`` of shape (h, w),
    decoded by the library's thread pool (``SlcLoader`` in slc_io.cpp):
    ``slots`` frames of read-ahead, ``threads`` decoders, frames
    delivered strictly in list order. Raises RuntimeError for arguments
    the pool refuses, and IOError for a frame that fails to decode (the
    stream goes on with the next ``__next__``). A build failure of the
    library raises from here too: there is no fallback.
    """

    def __init__(self, paths, h: int, w: int, slots: int = 8,
                 threads: int = 4):
        self._lib = lib()
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h, self._w = h, w
        self._handle = self._lib.slc_loader_create(arr, len(self._paths), h,
                                                   w, slots, threads)
        if not self._handle:
            raise RuntimeError("slc_loader_create failed")
        self._idx = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        out = np.empty((self._h, self._w), np.uint8)
        rc = self._lib.slc_loader_next(self._handle, out.ctypes.data_as(_u8p))
        i = self._idx
        self._idx += 1
        if rc == 0:
            _count("loader_frames")
            return out
        if rc == 1:
            self.close()
            raise StopIteration
        raise IOError(f"native BMP decode failed (rc={rc}) for "
                      f"{os.fsdecode(self._paths[i])}")

    def close(self) -> None:
        """Stop and join the pool; idempotent."""
        if self._handle is not None:
            self._lib.slc_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best effort: close() is the real API
        try:
            self.close()
        except Exception:
            pass
