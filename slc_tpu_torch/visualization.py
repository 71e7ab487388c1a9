"""Debug visualization and image archival (a copy of
slc_tpu/visualization.py, which is numpy-only; BMPs through the port's
codec, slc_tpu_torch.io.bmp).

The reference's `CVisualization::Show` (DynaFrame/CVisualization.cpp:
22-115) normalizes any dtype to 8-bit and imshows/saves it, gated by the
VISUAL_DEBUG compile-time flag (StaticParameters.cpp:22); `CStorage::
Store` (DynaFrame/CStorage.cpp:41-55) batch-writes image stacks with an
auto-mkdir fallback. Headless GPU hosts have no HighGUI, so "show" means
"write a BMP/odd-frame dump you can scp" — the same debug affordance
without a display server. Gating is a runtime flag here, not a rebuild.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from slc_tpu_torch.io.bmp import write_bmp

#: Runtime debug gate (the VISUAL_DEBUG analog, StaticParameters.cpp:22).
VISUAL_DEBUG = bool(int(os.environ.get("SLC_VISUAL_DEBUG", "0")))


def resize_bilinear(img, zoom: float) -> np.ndarray:
    """Bilinear resize by a scale factor, with OpenCV's pixel-center
    mapping src = (dst + 0.5)/zoom - 0.5 — the ``resize`` call inside
    CVisualization::Show (CVisualization.cpp:24-25, INTER_LINEAR
    default). Output size rounds to nearest like cv::Size's
    saturate_cast<int>(w*zoom) (not floor: 100 * 2.9999999 -> 300)."""
    a = np.asarray(img)
    if zoom == 1.0:
        return a
    h, w = a.shape[:2]
    oh, ow = max(int(round(h * zoom)), 1), max(int(round(w * zoom)), 1)
    sy = np.clip((np.arange(oh) + 0.5) * (h / oh) - 0.5, 0, h - 1)
    sx = np.clip((np.arange(ow) + 0.5) * (w / ow) - 0.5, 0, w - 1)
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    # Weight shapes broadcast over any trailing axes (e.g. RGB).
    trail = (1,) * (a.ndim - 2)
    fy = (sy - y0).reshape(oh, 1, *trail)
    fx = (sx - x0).reshape(1, ow, *trail)
    af = a.astype(np.float64)
    top = af[y0][:, x0] * (1 - fx) + af[y0][:, x1] * fx
    bot = af[y1][:, x0] * (1 - fx) + af[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(a.dtype, np.integer):
        info = np.iinfo(a.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(a.dtype)


def to_display(img, normalize: bool = True, zoom: float = 1.0
               ) -> np.ndarray:
    """Any 2D array -> uint8 for display: optional zoom resize then
    per-call min-max normalization (CVisualization.cpp:22-106 behavior
    incl. the ``zoom`` parameter of CVisualization.h:18, minus the
    reference normalizers' static-cache bug)."""
    a = resize_bilinear(np.asarray(img), zoom)
    if a.dtype == np.uint8 and not normalize:
        return a
    a = a.astype(np.float64)
    lo, hi = float(a.min()), float(a.max())
    if hi - lo < 1e-20:
        return np.zeros(a.shape, np.uint8)
    return ((a - lo) / (hi - lo) * 255.0).astype(np.uint8)


def normalize_depth_u16(depth) -> np.ndarray:
    """uint16-mm depth map -> uint8 display, exact reference arithmetic:
    (v - min)/(max - min) * 255, truncated (depthMapUtils.cpp:191-210,
    normalizeDepthImage / normalizeInfraredImage :216-235). min/max are
    recomputed per call — the reference's ``static`` min/max (``:198-199``)
    poison every call after the first and are deliberately not
    reproduced (SURVEY §5 "known latent bugs"). Delegates to
    :func:`to_display`, whose normalize path is the same arithmetic."""
    return to_display(np.asarray(depth, np.uint16))


def normalize_f64(depth) -> np.ndarray:
    """float64 depth map -> uint8 display with the reference's
    brightening quirk: the normalization ceiling is 0.01 * max (values
    above it saturate to 255) — normalize64FImage,
    depthMapUtils.cpp:242-262 (``max*0.01`` at :249, clamp at :259).
    Per-call min/max (the static-cache bug is not reproduced)."""
    a = np.asarray(depth, np.float64)
    lo = float(a.min())
    hi = float(a.max()) * 0.01
    if hi - lo < 1e-20:
        return np.zeros(a.shape, np.uint8)
    v = (a - lo) / (hi - lo) * 255.0
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def show(name: str, img, out_dir: str = "debug_vis",
         normalize: bool = True, force: bool = False,
         zoom: float = 1.0) -> Optional[str]:
    """Debug dump: write ``<out_dir>/<name>.bmp`` when VISUAL_DEBUG (or
    ``force``); returns the path written or None. The call-site pattern
    mirrors the reference's gated Show calls (CDecodeGray.cpp:207-227);
    ``zoom`` scales the image first (CVisualization.h:18)."""
    if not (VISUAL_DEBUG or force):
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.bmp")
    write_bmp(path, to_display(img, normalize, zoom))
    return path


def store_images(images: Sequence, directory: str, name: str,
                 start_idx: int = 0, suffix: str = ".bmp") -> int:
    """Batch image archival: ``<dir>/<name><idx><suffix>`` with
    auto-mkdir (CStorage::Store, CStorage.cpp:41-55 — minus its
    ``system("mkdir")`` shell-out). Returns the number written."""
    os.makedirs(directory, exist_ok=True)
    if suffix.lower() not in (".bmp",):
        raise ValueError(f"unsupported suffix {suffix} (BMP codec only)")
    n = 0
    for i, img in enumerate(images):
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = to_display(a)
        write_bmp(os.path.join(directory,
                               f"{name}{start_idx + i}{suffix}"), a)
        n += 1
    return n
