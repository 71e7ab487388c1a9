"""Multi-frequency heterodyne absolute decode (frame 0, ``--mode
heterodyne``).

Source note. Replaces slc_tpu/pallas/heterodyne.py:201
``heterodyne_decode_pallas``. The CUDA kernel (csrc/heterodyne.cu) runs
four neighbouring pixels of a row a thread, one 4-byte load per plane and
one float4 store per map: the N-step phase of every frequency -> the
minimum modulation over the frequencies -> the beat cascade and its
unwrap down the left spine -> the modulation mask -> triangulation, with
C and D rebuilt from their six coefficients. The reference's 3
frequencies x 4 steps take an instance with its loops unrolled; any
other (F, N) up to MAX_FREQS x MAX_STEPS a generic instance. It ports the
plain path's semantics, not the TPU's workarounds: ``atan2f`` and IEEE
division instead of the polynomial atan2 and the Newton reciprocal. On
the card it moves F*N u8 planes in and 4 f32 maps out, 28 B/px at the
reference's 3 frequencies x 4 steps, but its instruction throughput
binds it more: three atan2f and nine IEEE divisions a pixel,
each with its checks and slow-path branches.

``heterodyne_decode`` dispatches on the device of its input: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops.phase import decode_phase, modulation
from slc_tpu_torch.ops.triangulate import triangulate_xyz
from slc_tpu_torch.ops.unwrap import beat_periods, heterodyne_unwrap

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: Limits of the kernel's per-call constant block (csrc/heterodyne.cu).
MAX_FREQS = 8
MAX_STEPS = 16


def check_stack(images: torch.Tensor, cfg: SystemConfig,
                het: HeterodyneConfig) -> None:
    """Raise unless ``images`` is the (F*N, H, W) stack of ``het``, with
    N >= 3: with fewer steps every sine coefficient vanishes, and phase
    shifting is under-determined (slc_tpu/pallas/heterodyne.py:222-225)."""
    if het.phase_steps < 3:
        raise ValueError(f"n_steps must be >= 3, got {het.phase_steps}")
    want = (het.num_images, cfg.cam_h, cfg.cam_w)
    if tuple(images.shape) != want:
        raise ValueError(f"fringe images: expected shape {want}, got "
                         f"{tuple(images.shape)}")


def heterodyne_decode_ref(images: torch.Tensor,
                          tables: TriangulationTables, cfg: SystemConfig,
                          het: HeterodyneConfig,
                          min_modulation: Optional[float] = 2.0) -> Maps:
    """Plain PyTorch version: the composite path of
    slc_tpu/pipeline.py:136-154. Returns (x, y, z, proj_u)."""
    check_stack(images, cfg, het)
    n = het.phase_steps
    periods = het.periods(cfg.pro_w)
    stacks = [images[i * n:(i + 1) * n] for i in range(len(periods))]
    # decode_phase's (0, T] convention gives x mod T for the pattern model
    # (the +0.5 px decoder offset cancels the -0.5 px pattern origin); a
    # value of T is congruent to 0 and absorbed by the fractional wrap.
    wrapped = torch.stack([decode_phase(s, float(p))
                           for s, p in zip(stacks, periods)])
    proj_u = heterodyne_unwrap(wrapped, periods, float(cfg.pro_w))
    valid = None
    if min_modulation is not None:
        mods = [modulation(s) for s in stacks]
        valid = functools.reduce(torch.minimum, mods) > min_modulation
        proj_u = torch.where(valid, proj_u, torch.zeros_like(proj_u))
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                              valid)
    return x, y, z, proj_u


def _floats(vals):
    return (ctypes.c_float * max(1, len(vals)))(*vals)


def heterodyne_decode_cuda(images: torch.Tensor,
                           tables: TriangulationTables, cfg: SystemConfig,
                           het: HeterodyneConfig,
                           min_modulation: Optional[float] = 2.0) -> Maps:
    """The hand-written kernel. ``images``: the contiguous (F*N, H, W) u8
    fringe stack, finest frequency first, on one CUDA device."""
    check_stack(images, cfg, het)
    n = het.phase_steps
    periods = het.periods(cfg.pro_w)
    if len(periods) > MAX_FREQS or n > MAX_STEPS:
        raise ValueError(f"the kernel takes at most {MAX_FREQS} frequencies "
                         f"of at most {MAX_STEPS} steps, got "
                         f"{len(periods)} x {n}")
    spine, coarse = beat_periods(periods, float(cfg.pro_w))
    dev = images.device
    h, w = cfg.cam_h, cfg.cam_w
    _build.require(images, "fringe images", torch.uint8,
                   (het.num_images, h, w), dev)
    _build.require(tables.c, "tables.c", torch.float32, (h, w), dev)
    # The step coefficients exactly as ops.phase.phase_sincos makes them:
    # float32 cos/sin of the float32 step angle.
    k = torch.arange(n, dtype=torch.float32) * (2.0 * math.pi / n)
    ck, sk = torch.cos(k).tolist(), torch.sin(k).tolist()
    scales = [float(np.float32(p) / np.float32(2.0 * math.pi))
              for p in periods]
    x, y, z, pu = (torch.empty((h, w), dtype=torch.float32, device=dev)
                   for _ in range(4))
    use_mod = min_modulation is not None
    tri = _build.tri_array(tables.coeffs, cfg.fov_min, cfg.fov_max)
    _build.launch(
        "slc_heterodyne", dev, images.data_ptr(), x.data_ptr(),
        y.data_ptr(), z.data_ptr(), pu.data_ptr(), h, w, len(periods), n,
        _floats(periods), _floats(scales), _floats(spine), coarse,
        float(cfg.pro_w), _floats(ck), _floats(sk), 2.0 / n, int(use_mod),
        float(min_modulation) if use_mod else 0.0, tri)
    heterodyne_decode_cuda.launches += 1
    return x, y, z, pu


heterodyne_decode_cuda.launches = 0


def heterodyne_decode(images: torch.Tensor, tables: TriangulationTables,
                      cfg: SystemConfig, het: HeterodyneConfig,
                      min_modulation: Optional[float] = 2.0) -> Maps:
    """Heterodyne absolute decode: CPU tensors take the plain version,
    anything else the kernel."""
    if images.device.type == "cpu":
        return heterodyne_decode_ref(images, tables, cfg, het,
                                     min_modulation)
    return heterodyne_decode_cuda(images, tables, cfg, het, min_modulation)
