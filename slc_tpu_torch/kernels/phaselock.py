"""The standalone phase lock: lock-in correction of a given prediction,
then re-triangulation.

Source note. ``phase_lock_cuda`` replaces slc_tpu/pallas/phaselock.py:216
``phase_lock_pallas``, the two-kernel form of the locked step that
slc_tpu keeps as the comparison point for its fused step. It runs the
locked step's three lock launches (csrc/dynamic_step.cu ``launch_lock``:
``lock_dc``, ``lock_corr``, ``snap``) on the caller's prediction instead
of the P' of the step's track launch, so the two cannot drift apart: the
open-loop step followed by this lock equals the fused locked step bit for
bit. It moves 21 B/px at its floor (u8 frame and f32 P in, P, z, x, y
out); DC and the correction map pass through device memory and stay in
L2 at the reference size. The prediction is only read: P lands in a fresh
map.

Gate bands are ``ops.demod.GATE_BAND`` rows aligned to row 0, the
default ``block_h`` of ``phase_lock_pallas``. ``max_carrier_gradient`` 0
or inf turns the gate off (slc_tpu/ops/demod.py:204), not the TPU
kernel's inverted reading.

``phase_lock`` dispatches on the device of the frame: CPU tensors take the
plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels.dynamic_step import (check_lock_args, gate_args,
                                                lock_buffers)
from slc_tpu_torch.ops.demod import GATE_BAND, stripe_phase_correction
from slc_tpu_torch.ops.triangulate import triangulate_xyz

#: (proj_u, z, x, y), each (H, W) float32.
LockMaps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def phase_lock_ref(frame: torch.Tensor, pu_pred: torch.Tensor,
                   tables: TriangulationTables, *, period: float,
                   win_u: int = 9, win_v: int = 9, amp_floor: float = 8.0,
                   max_carrier_gradient: float = 2e-3, fov_min: float = 10.0,
                   fov_max: float = 100.0) -> LockMaps:
    """Plain PyTorch version: ``ops.demod.stripe_phase_correction`` on the
    prediction, then ``ops.triangulate.triangulate_xyz`` (the composite
    slc_tpu's tests hold the Pallas kernel against,
    tests/test_pallas.py:315-318)."""
    dp, _ = stripe_phase_correction(frame, pu_pred, period, win_u, win_v,
                                    amp_floor=amp_floor,
                                    max_carrier_gradient=max_carrier_gradient)
    pu = pu_pred.float() + dp
    x, y, z = triangulate_xyz(pu, tables, fov_min, fov_max)
    return pu, z, x, y


def phase_lock_cuda(frame: torch.Tensor, pu_pred: torch.Tensor,
                    tables: TriangulationTables, *, period: float,
                    win_u: int = 9, win_v: int = 9, amp_floor: float = 8.0,
                    max_carrier_gradient: float = 2e-3,
                    fov_min: float = 10.0, fov_max: float = 100.0
                    ) -> LockMaps:
    """The hand-written lock (three launches). ``frame`` contiguous (H, W)
    u8 and ``pu_pred`` (H, W) float32 on one CUDA device."""
    check_lock_args(period, win_u, win_v)
    if frame.ndim != 2 or frame.numel() == 0:
        raise ValueError(f"frame: expected a non-empty (H, W) tensor, got "
                         f"{tuple(frame.shape)}")
    dev = frame.device
    h, w = frame.shape
    _build.require(frame, "frame", torch.uint8, (h, w), dev)
    for name, t in (("pu_pred", pu_pred), ("tables.c", tables.c)):
        _build.require(t, name, torch.float32, (h, w), dev)
    pu, z, x, y = out = tuple(torch.empty((h, w), dtype=torch.float32,
                                          device=dev) for _ in range(4))
    scratch, wu, wv = lock_buffers(h, w, win_u, win_v, dev)
    tri = _build.tri_array(tables.coeffs, fov_min, fov_max)
    _build.launch(
        "slc_phase_lock", dev, frame.data_ptr(), pu_pred.data_ptr(),
        pu.data_ptr(), z.data_ptr(), x.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), wu.data_ptr(), wv.data_ptr(), h, w,
        float(period), win_u, win_v, float(amp_floor),
        *gate_args(max_carrier_gradient), GATE_BAND, tri)
    phase_lock_cuda.launches += 1
    return out


phase_lock_cuda.launches = 0


def phase_lock(frame: torch.Tensor, pu_pred: torch.Tensor,
               tables: TriangulationTables, **kw) -> LockMaps:
    """Lock ``pu_pred`` to the carrier phase of ``frame`` and
    re-triangulate: CPU tensors take the plain version, anything else the
    kernel. Returns (proj_u, z, x, y)."""
    fn = phase_lock_ref if frame.device.type == "cpu" else phase_lock_cuda
    return fn(frame, pu_pred, tables, **kw)
