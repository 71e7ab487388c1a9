"""Point clouds, normals, shaded preview renders and their writers
(PyTorch port of slc_tpu/cloud.py).

The reference's point-cloud utilities (DynaFrame/depthMapUtils.cpp) and
result writer (DynaFrame/CCalculation.cpp:323-357): per-pixel loops
become dense tensor maps on the device of their input. The preview
render's bilateral filter is the hand-written kernel on a CUDA tensor
(kernels.bilateral) and its plain version on a CPU tensor; out-of-image
neighbours count as missing, as in slc_tpu's TPU kernel. The latent
``static`` min/max caching bug of the reference normalizers
(depthMapUtils.cpp:198-199) is deliberately not reproduced. The per-frame
ASCII dump goes through the native writer of slc_tpu_torch/io/native, as
slc_tpu writes it.
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


def pinhole_points(z: torch.Tensor, col: torch.Tensor, row: torch.Tensor,
                   fx, fy, cx, cy, flip_xz: bool = False) -> torch.Tensor:
    """Camera-frame points (..., 3) of depths ``z`` at float32 pixel
    columns ``col`` and rows ``row`` (broadcast against ``z``): the
    arithmetic of :func:`depth_to_cloud`, at any set of pixels."""
    u = col - cx
    v = row - cy
    if flip_xz:
        z = -z
        x = -u * z / fx
    else:
        x = u * z / fx
    y = v * z / fy
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def depth_to_cloud(depth: torch.Tensor, fx, fy, cx, cy,
                   flip_xz: bool = False) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W, 3) camera-frame points via the
    pinhole model; depth == 0 marks invalid (depthMapUtils.cpp:5-39).

    ``flip_xz`` reproduces the reference's sign convention z' = -z,
    x' = -(j-cx) z'/fx (depthMapUtils.cpp:32-34); default is the plain
    camera frame used by the main pipeline (CCalculation.cpp:756-771).
    """
    h, w = depth.shape[-2:]
    col = torch.arange(w, dtype=torch.float32, device=depth.device)
    row = torch.arange(h, dtype=torch.float32, device=depth.device)
    return pinhole_points(depth.float(), col[None, :], row[:, None], fx, fy,
                          cx, cy, flip_xz)


def unit_normals(c: torch.Tensor, right: torch.Tensor,
                 down: torch.Tensor) -> torch.Tensor:
    """n = (down - c) x (right - c), normalized (depthMapUtils.cpp:116)."""
    n = torch.linalg.cross(down - c, right - c, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / norm.clamp_min(1e-20)


def cloud_normals(cloud: torch.Tensor, valid: torch.Tensor):
    """Right/down-neighbour cross-product normals
    (depthMapUtils.cpp:96-121) of an (..., H, W, 3) cloud. A pixel's
    normal is valid only if itself, its right and its down neighbour are
    valid; the last row/column are invalid. Returns (normals (..., H, W,
    3), valid (..., H, W))."""
    n = unit_normals(cloud, torch.roll(cloud, -1, dims=-2),
                     torch.roll(cloud, -1, dims=-3))
    h, w = valid.shape[-2:]
    row = torch.arange(h, device=valid.device)[:, None]
    col = torch.arange(w, device=valid.device)[None, :]
    ok = (valid & torch.roll(valid, -1, dims=-1)
          & torch.roll(valid, -1, dims=-2) & (row < h - 1) & (col < w - 1))
    return torch.where(ok[..., None], n, 0.0), ok


def luminance_map(cloud: torch.Tensor, normals: torch.Tensor,
                  valid: torch.Tensor,
                  camera_position=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Phong-style shaded preview (depthMapUtils.cpp:124-164): point
    light at the origin, ambient 60 / diffuse 150 / specular 50 with
    exponent 0.2, clamped to [0, 255] and truncated to uint8; invalid
    pixels are 0."""
    i_amb, i_diff, i_spec, n_s = 60.0, 150.0, 50.0, 0.2
    cam = torch.tensor(camera_position, dtype=torch.float32,
                       device=cloud.device)

    def unit(x):
        return x / torch.linalg.vector_norm(
            x, dim=-1, keepdim=True).clamp_min(1e-20)

    ray = unit(-cloud)                                  # light at origin
    ndotr = torch.sum(normals * ray, dim=-1)
    spec_ray = 2.0 * ndotr[..., None] * normals - ray
    view = unit(cam - cloud)
    s = torch.sum(view * spec_ray, dim=-1)
    intensity = (i_amb + i_diff * ndotr.abs()
                 + torch.where(s > 0, i_spec * torch.pow(s.clamp_min(1e-20),
                                                         n_s), 0.0))
    intensity = intensity.clamp(0.0, 255.0)
    return torch.where(valid, intensity, 0.0).to(torch.uint8)


def render_depth_map(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Full preview render (depthMapUtils.cpp:167-187): bilateral-filter
    the depth for normal estimation, shade the RAW depth's cloud with the
    filtered normals. (H, W) float32 depth -> (H, W) uint8 on its
    device."""
    from slc_tpu_torch.kernels.bilateral import bilateral_filter
    filtered = bilateral_filter(depth, radius=1, sigma_color=10.0,
                                sigma_space=25.0)
    normals, ok = cloud_normals(depth_to_cloud(filtered, fx, fy, cx, cy),
                                filtered > 0)
    return luminance_map(depth_to_cloud(depth, fx, fy, cx, cy), normals, ok)


def normalize_to_u8(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalize any image to uint8 for display: the fixed
    version of the reference normalizers (depthMapUtils.cpp:191-262),
    recomputing the range per call instead of caching it in statics."""
    x = torch.as_tensor(img).float()
    lo, hi = x.min(), x.max()
    y = (x - lo) / (hi - lo).clamp_min(1e-20) * 255.0
    return y.clamp(0.0, 255.0).to(torch.uint8)


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


def write_xyz_normals(path: str, cloud, normals, valid) -> int:
    """'x y z nx ny nz' export (depthMapUtils.cpp:43-60)."""
    c = _host(cloud).astype(np.float64).reshape(-1, 3)
    n = _host(normals).astype(np.float64).reshape(-1, 3)
    m = _host(valid).astype(bool).ravel()
    pts = np.concatenate([c[m], n[m]], axis=1)
    np.savetxt(path, pts, fmt="%.7f")
    return int(pts.shape[0])


def write_xyz_rgb(path: str, cloud, valid, color=None) -> int:
    """'x y z r g b' export (depthMapUtils.cpp:62-93); grayscale colors
    are broadcast to r = g = b, absent colors to white."""
    c = _host(cloud).astype(np.float64).reshape(-1, 3)
    m = _host(valid).astype(bool).ravel()
    if color is None:
        rgb = np.full((c.shape[0], 3), 255, np.int64)
    else:
        col = _host(color)
        if col.ndim == 2 or (col.ndim == 3 and col.shape[-1] == 1):
            col = np.repeat(col.reshape(-1, 1), 3, axis=1)
        else:
            col = col.reshape(-1, 3)
        rgb = col.astype(np.int64)
    with open(path, "w") as f:
        for p, q in zip(c[m], rgb[m]):
            f.write(f"{p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]} {q[1]} {q[2]}\n")
    return int(m.sum())


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

        CUDA tensors are copied into pinned host memory here, by
        non-blocking copies on their device's current stream, and an
        event is recorded after them: the copies are ordered after the
        work that made the maps and before anything the caller queues
        next, so the caller may overwrite the maps afterwards (a CUDA
        graph's output buffers are, by the next replay). The writer
        thread waits on the event. CPU tensors are held as they are:
        nothing writes into a step's fresh maps afterwards
        (slc_tpu/cloud.py:227-247). Anything else is copied to a numpy
        array here.
        """
        maps, ready = [], None
        for a in (x, y, z):
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                host.copy_(a, non_blocking=True)
                a = host
                if ready is None:
                    ready = torch.cuda.Event()
            elif not isinstance(a, torch.Tensor):
                a = np.array(a)
            maps.append(a)
        if ready is not None:
            ready.record(torch.cuda.current_stream(z.device))
        self._q.put((path, ready, *maps))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, ready, *maps = item
            t0 = time.perf_counter()
            try:
                if ready is not None:
                    ready.synchronize()
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
        frame, ``writer_copy_ms`` the part of it spent getting the maps
        to the host (for tensors on a card, waiting for the pinned
        device-to-host copies that ``submit`` started)."""
        self._q.put(None)
        self._t.join()
        if self.errors:
            raise IOError("async cloud writes failed: "
                          + "; ".join(self.errors[:3]))
        return {"writer_frames": self.frames,
                "writer_points": self.points,
                "writer_total_ms": round(self.total_wall_s * 1e3, 3),
                "writer_copy_ms": round(self.copy_wall_s * 1e3, 3)}
