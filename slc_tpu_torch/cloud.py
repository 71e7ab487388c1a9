"""Point-cloud writers (PyTorch port of the writers of slc_tpu/cloud.py:
the reference's per-frame ASCII dump, CCalculation.cpp:323-357, through
the native writer of slc_tpu_torch/io/native as slc_tpu writes it, the npz
maps, and the background writer). Normals and preview renders are not
ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from slc_tpu_torch.io import native


def _host(a) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_xyz(path: str, x, y, z, mask: Optional[np.ndarray] = None) -> int:
    """Write 'x y z' lines for valid pixels (z > 0 unless ``mask`` is
    given), the per-frame output of the reference pipeline
    (CCalculation.cpp:341-350). Returns the number of points written.

    Without ``mask`` the native writer formats float32 host copies of the
    maps (slc_write_xyz: 7 decimals, the bytes slc_tpu/cloud.py:131-145
    writes; the ~1.3M-point dump is bound by formatting, which the
    reference pays in iostream every frame, CCalculation.cpp:348-350). A
    ``mask`` takes ``np.savetxt``, as in slc_tpu."""
    if mask is None:
        return native.write_xyz(path, *(_host(a) for a in (x, y, z)))
    x, y, z = (_host(a).astype(np.float64).ravel() for a in (x, y, z))
    m = np.asarray(mask, bool).ravel()
    pts = np.stack([x[m], y[m], z[m]], axis=1)
    np.savetxt(path, pts, fmt="%.7f")
    return int(pts.shape[0])


def write_cloud_npz(path: str, x, y, z) -> int:
    """Float32 x/y/z maps with pixel indexing preserved (what the ASCII
    dump drops). Returns the valid-point count."""
    x, y, z = (_host(a).astype(np.float32) for a in (x, y, z))
    np.savez(path, x=x, y=y, z=z)
    return int((z > 0).sum())


class AsyncCloudWriter:
    """Background point-cloud writer: takes per-frame results off the
    reconstruction loop's critical path (the reference blocks its loop
    on an ASCII dump every frame, CCalculation.cpp:310-315).

    ``fmt``: "xyz" (reference-format ASCII) or "npz" (float32 maps).
    """

    def __init__(self, fmt: str = "xyz", queue_depth: int = 4):
        if fmt not in ("xyz", "npz"):
            raise ValueError(f"unknown cloud format {fmt!r}")
        self.fmt = fmt
        self.frames = 0
        self.points = 0
        self.total_wall_s = 0.0
        self.copy_wall_s = 0.0
        self.errors: list = []
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def submit(self, path: str, x, y, z) -> None:
        """Enqueue one frame's maps for background serialization.

        INVARIANT: the contents of ``x``/``y``/``z`` must not change
        after this call (slc_tpu/cloud.py:227-247). Tensors are held as
        they are and copied to the host by the writer thread, which is
        safe because every tracker step returns freshly allocated maps
        and nothing writes into them afterwards; the device-to-host copy
        is ordered after the step on the same stream. Anything else is
        copied to a numpy array here.
        """
        pinned = [a if isinstance(a, torch.Tensor) else np.array(a)
                  for a in (x, y, z)]
        self._q.put((path, *pinned))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, *maps = item
            t0 = time.perf_counter()
            try:
                x, y, z = (_host(a) for a in maps)
                self.copy_wall_s += time.perf_counter() - t0
                if self.fmt == "npz":
                    self.points += write_cloud_npz(path, x, y, z)
                else:
                    self.points += write_xyz(path, x, y, z)
                self.frames += 1
            except Exception as e:            # surfaced via close()
                self.errors.append(f"{path}: {e}")
            self.total_wall_s += time.perf_counter() - t0

    def close(self) -> dict:
        """Flush, join, and return a summary; raises the first write
        errors, if any (a silently lost frame is worse than a failed
        run). ``writer_total_ms`` is the thread's wall time over every
        frame, ``writer_copy_ms`` the part of it that copied the maps to
        the host (device to host for tensors on a card)."""
        self._q.put(None)
        self._t.join()
        if self.errors:
            raise IOError("async cloud writes failed: "
                          + "; ".join(self.errors[:3]))
        return {"writer_frames": self.frames,
                "writer_points": self.points,
                "writer_total_ms": round(self.total_wall_s * 1e3, 3),
                "writer_copy_ms": round(self.copy_wall_s * 1e3, 3)}
