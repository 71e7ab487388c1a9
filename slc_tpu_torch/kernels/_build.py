"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file (plus the shared ``csrc/*.cuh`` headers) is
compiled by its own ``nvcc``, all at once, and the objects are linked
into ONE shared library with a plain C interface, loaded through
``ctypes``. The build runs at first use, never at import,
so the package imports on a machine without ``nvcc``. The library lands
in ``kernels/build/`` under a name keyed by a hash of the sources and
flags, so editing a source rebuilds it. A failed build raises with
nvcc's stderr: there is no fallback.

Every kernel launch goes through :func:`launch`, which enters
``torch.cuda.device`` of the tensors' device around the C call: the C
functions launch with ``<<<...>>>`` and set function attributes on the
calling thread's current device, so that device must be the tensors'.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from slc_tpu_torch import metrics

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(_DIR, "build")

#: No --use_fast_math: the kernels rely on IEEE division and sqrt.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

#: C signatures: every pointer and the stream as c_void_p, so ctypes
#: passes 64-bit values; every function returns a cudaError_t.
_SIGNATURES = {
    # gray, phase, x, y, z, pu, h, w, gray_bits, n_steps, gray_period,
    # phase_period, use_mod, min_mod_sq, tri (host float[14]), stream
    "slc_grayphase": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _f,
                      _i, _f, _vp, _vp],
    # frame, strip_w, strip_b, h, w, window, subpixel, fbits, stream
    "slc_stripe": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # frame, prev_sw, prev_sb, prev_pu, pu, sw, sb, z, x, y, h, w, window,
    # subpixel, fbits, scale_gradient, robust, tri, stream
    "slc_dynamic_step": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                         _i, _i, _i, _i, _i, _i, _i, _vp, _vp],
    # frame, prev_sw, prev_sb, prev_pu, pu, sw, sb, z, x, y, scratch,
    # wu, wv, h, w, window, subpixel, fbits, scale_gradient, robust,
    # period, win_u, win_v, amp_floor, gate_on, gate_thresh, gate_band,
    # ablate, tri, stream
    "slc_dynamic_step_lock": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                              _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                              _i, _f, _i, _i, _f, _i, _f, _i, _i, _vp,
                              _vp],
    # frame, pred, pu, z, x, y, scratch, wu, wv, h, w, period, win_u,
    # win_v, amp_floor, gate_on, gate_thresh, gate_band, tri, stream
    "slc_phase_lock": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                       _f, _i, _i, _f, _i, _f, _i, _vp, _vp],
    # img, out (n_out maps), n_out, h, w, halo, stream
    "slc_halo_block_floor_u8": [_vp, _vp, _i, _i, _i, _i, _vp],
    "slc_halo_block_floor_f32": [_vp, _vp, _i, _i, _i, _i, _vp],
    # images, x, y, z, pu, h, w, nfreq, n, periods, scales, spine (host
    # float arrays), coarse, extent, ck, sk (host), two_over_n, use_mod,
    # min_mod, tri, stream
    "slc_heterodyne": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp, _vp,
                       _vp, _f, _f, _vp, _vp, _f, _i, _f, _vp, _vp],
    # img, out, h, w, inv2sc, inv2ss, stream
    "slc_bilateral": [_vp, _vp, _i, _i, _f, _f, _vp],
    # r, wy, wx, dinv, e, res, h, w, omega, stream
    "slc_mg_down": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _f, _vp],
    # e, r, wy, wx, dinv, out, h, w, omega, stream
    "slc_mg_up": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _f, _vp],
    # r, wy, wx, dinv, e, h, w, omega, sweeps, stream
    "slc_mg_coarse": [_vp, _vp, _vp, _vp, _vp, _i, _i, _f, _i, _vp],
    # src (host void*[n]), n, part_bytes, pinned, dev, timed, stream
    "slc_stage_h2d": [_vp, _i, ctypes.c_size_t, _vp, _vp, _i, _vp],
    # pu, h, w, work, out, stream
    "slc_lock_window": [_vp, _i, _i, _vp, _vp, _vp],
    # obs, mask, landmarks, normals, rot, trans, rot_out, trans_out, part1,
    # part2, center, info, views, l, blocks, damping, stream
    "slc_p2l_step": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                     _vp, _i, _i, _i, _f, _vp],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's conventional home ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin/nvcc, PATH, /usr/local/cuda): "
        "the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _library_path(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libslc_kernels_{h.hexdigest()[:16]}.so")


def _nvcc_error(cmd, proc_rc, stderr) -> RuntimeError:
    return RuntimeError(f"nvcc failed (exit {proc_rc}): {' '.join(cmd)}\n"
                        f"{stderr}")


def build(extra=()) -> str:
    """Compile the library if no build of the current sources exists;
    return its path. One nvcc per source, all started together, then one
    link. ``extra`` nvcc flags (profiling builds of ``tools/``, such as
    ``-DSLC_TRACK_STOP=1``) give a library of their own. Raises
    RuntimeError with nvcc's stderr on failure."""
    flags = (*NVCC_FLAGS, *extra)
    path = _library_path(flags)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = []
    try:
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *flags, "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise _nvcc_error(cmd, proc.returncode, err)
        cmd = [nvcc, *flags, "-shared", "-o", tmp, *objs]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise _nvcc_error(cmd, link.returncode, link.stderr)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)             # atomic: concurrent builders agree
    return path


def load(path: str) -> ctypes.CDLL:
    """The kernel library at ``path``, its C signatures declared."""
    l = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(l, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    l.slc_error_string.argtypes = [_i]
    l.slc_error_string.restype = ctypes.c_char_p
    l.slc_dynamic_step_lock_scratch.argtypes = [_i, _i, _i]
    l.slc_dynamic_step_lock_scratch.restype = ctypes.c_long
    l.slc_stage_stats.argtypes = [_vp, _i]
    l.slc_stage_stats.restype = None
    l.slc_lock_window_work_bytes.argtypes = []
    l.slc_lock_window_work_bytes.restype = ctypes.c_long
    return l


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


#: ``slc_stage_stats``'s values in its order: jobs timed, the sum and the
#: max of their start delays and the sum of their copies into pinned
#: memory, in ns.
STAGE_STATS = ("stage.jobs", "stage.fn_delay_ns", "stage.fn_delay_max_ns",
               "stage.copy_ns")


def stage_stats(reset: bool = False):
    """The frame stager's host-function timings, by the names of
    :data:`STAGE_STATS`, read and with ``reset`` zeroed; None where the
    library is not loaded (it is not built for this)."""
    if _lib is None:
        return None
    out = (ctypes.c_longlong * 4)()
    _lib.slc_stage_stats(out, int(reset))
    return dict(zip(STAGE_STATS, out))


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current
    stream of the CUDA ``device`` (the tensors' device), under
    ``torch.cuda.device(device)``; raise if it returned an error. The
    host time of the call is the span ``kernel.launch``."""
    with metrics.span("kernel.launch"):
        fn = getattr(lib(), name)
        with torch.cuda.device(device):
            err = fn(*args, stream_of(device))
    check(err, name)


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib().slc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on the CUDA ``device``: what a kernel takes, nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes cuda tensors, got one "
                         f"on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(device) -> int:
    """The current PyTorch stream of ``device``, as the C functions take
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def tri_array(coeffs, fov_min: float, fov_max: float):
    """The host float[14] of triangulation constants (see Tri in
    csrc/common.cuh). Keep it referenced for the duration of the call."""
    vals = tuple(coeffs) + (fov_min, fov_max)
    assert len(vals) == 14, len(vals)
    return (ctypes.c_float * 14)(*vals)
