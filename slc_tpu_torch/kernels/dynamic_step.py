"""The dynamic tracking step, open loop and phase-locked.

Source note. ``dynamic_step_open_cuda`` replaces
slc_tpu/pallas/dynamic_step.py:166 ``dynamic_step_pallas``;
``dynamic_step_lock_cuda`` replaces slc_tpu/pallas/dynamic_lock.py:297
``dynamic_step_lock_pallas``. Both steps move 37 B/px (frame u8 + carried
strips and P in, P, strips, z, x, y out), so device memory is their floor.
The open-loop step is one launch: stripe tracking on a 2-D tile with a
1 px halo, deltaP select, 3x3 mean, gradient scale, integration and
triangulation, all in shared memory and registers. The locked step adds
the lock-in demodulation, whose triangle filters reach up to 2*win_u - 1
columns and whose carrier gate spans whole 64-row bands; it runs as four
launches: track; ``lock_dc``, the DC triangle sums of the frame on a
64x32 tile with both passes in the block; ``lock_corr``, on one 64-row
band x 32 columns, the triangle sums C and S of the quadrature products
(kept in shared memory), then the correction map and the tile's gate
partials; and ``snap``, which reduces each band's partials in a fixed
order, gates, corrects and triangulates. Only DC, the correction and the
partials pass through device memory (they stay in L2 at the reference
size). Every sum keeps the plain version's order of additions.

``frac_bits`` > 0 is the fast sub-pixel mode of the stripe tracking
(kernels/stripe.py): the same winners, fractions quantized, in the
kernels and the plain versions alike. The locked step's fraction bits
follow the lanes of slc_tpu's locked kernel, width + 2*win_u.

Precondition of the kernels: the carried strips are zero within
window//2 px of the image border, as every tracker state is (the stripe
regression masks its border). The kernels pad the 3x3 mean and the
gradient with zeros where the plain path reflects and wraps; the two
agree only under this precondition (slc_tpu tests/test_pallas.py:39-45).

Each public function dispatches on the device of the frame: CPU tensors
take the plain PyTorch version (the composite of slc_tpu/dynamic.py:
183-202), CUDA tensors the kernel (or it raises). Every call returns
freshly allocated maps unless the caller passes ``out`` (the streaming
module's CUDA graphs do); the carried state is never updated in place.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels.stripe import check_window, fast_frac_bits
from slc_tpu_torch.ops.demod import (GATE_BAND, stripe_phase_correction,
                                     tri_weights_1d)
from slc_tpu_torch.ops.filters import box_blur_3x3
from slc_tpu_torch.ops.stripe import (box_sum_vertical, select_delta_p,
                                      windowed_extrema)
from slc_tpu_torch.ops.triangulate import triangulate_xyz

#: (proj_u, strip_w, strip_b, z, x, y), each (H, W) float32.
StepMaps = Tuple[torch.Tensor, ...]
STEP_OUT = ("proj_u", "strip_w", "strip_b", "z", "x", "y")


def _track_ref(frame, prev_sw, prev_sb, prev_pu, window, subpixel,
               scale_gradient, robust, fbits):
    """Stripe track -> deltaP select -> 3x3 mean -> gradient scale ->
    P integration (slc_tpu/dynamic.py:183-193)."""
    sw, sb = windowed_extrema(box_sum_vertical(frame, window), window,
                              subpixel, fbits)
    dp = box_blur_3x3(select_delta_p(prev_sw, prev_sb, sw, sb,
                                     robust=robust))
    if scale_gradient:
        g = 0.5 * (torch.roll(prev_pu, -1, dims=1)
                   - torch.roll(prev_pu, 1, dims=1))
        dp = dp * g.clamp(0.2, 5.0)
    return prev_pu + dp, sw, sb


def dynamic_step_open_ref(frame: torch.Tensor, prev_sw: torch.Tensor,
                          prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                          tables: TriangulationTables, *, window: int = 21,
                          subpixel: bool = True, scale_gradient: bool = True,
                          robust: bool = True, fov_min: float = 10.0,
                          fov_max: float = 100.0,
                          frac_bits: int = 0) -> StepMaps:
    """Plain PyTorch open-loop step."""
    fbits = fast_frac_bits(frac_bits, window, frame.shape[-1], subpixel)
    pu, sw, sb = _track_ref(frame, prev_sw, prev_sb, prev_pu, window,
                            subpixel, scale_gradient, robust, fbits)
    x, y, z = triangulate_xyz(pu, tables, fov_min, fov_max)
    return pu, sw, sb, z, x, y


def dynamic_step_lock_ref(frame: torch.Tensor, prev_sw: torch.Tensor,
                          prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                          tables: TriangulationTables, *, window: int = 21,
                          subpixel: bool = True, scale_gradient: bool = True,
                          robust: bool = True, fov_min: float = 10.0,
                          fov_max: float = 100.0, period: float = 12.0,
                          win_u: int = 21, win_v: int = 9,
                          amp_floor: float = 8.0,
                          max_carrier_gradient: float = 2e-3,
                          frac_bits: int = 0,
                          gates: Optional[torch.Tensor] = None) -> StepMaps:
    """Plain PyTorch locked step: the open-loop integration, then the
    lock-in correction (slc_tpu/dynamic.py:194-198). ``gates``: as for
    :func:`slc_tpu_torch.ops.demod.stripe_phase_correction`."""
    fbits = fast_frac_bits(frac_bits, window, frame.shape[-1] + 2 * win_u,
                           subpixel)
    pu, sw, sb = _track_ref(frame, prev_sw, prev_sb, prev_pu, window,
                            subpixel, scale_gradient, robust, fbits)
    dpl, _ = stripe_phase_correction(frame, pu, period, win_u, win_v,
                                     amp_floor=amp_floor,
                                     max_carrier_gradient=max_carrier_gradient,
                                     gates=gates)
    pu = pu + dpl
    x, y, z = triangulate_xyz(pu, tables, fov_min, fov_max)
    return pu, sw, sb, z, x, y


def _check_inputs(frame, prev_sw, prev_sb, prev_pu, tables, window,
                  frac_bits):
    check_window(window)
    if frac_bits < 0:
        raise ValueError(f"frac_bits must be >= 0, got {frac_bits}")
    if frame.ndim != 2 or frame.numel() == 0:
        raise ValueError(f"frame: expected a non-empty (H, W) tensor, got "
                         f"{tuple(frame.shape)}")
    dev = frame.device
    h, w = frame.shape
    _build.require(frame, "frame", torch.uint8, (h, w), dev)
    for name, t in (("prev_sw", prev_sw), ("prev_sb", prev_sb),
                    ("prev_pu", prev_pu), ("tables.c", tables.c)):
        _build.require(t, name, torch.float32, (h, w), dev)
    return dev, h, w


def _out_maps(out, inputs, h, w, dev):
    """Six fresh (H, W) float32 maps, or the caller's ``out`` after
    checking it: contiguous float32 (H, W) maps on ``dev``, none
    overlapping an input (the kernels read each input's neighbourhood
    while other blocks write their outputs)."""
    if out is None:
        return tuple(torch.empty((h, w), dtype=torch.float32, device=dev)
                     for _ in range(6))
    out = tuple(out)
    if len(out) != 6:
        raise ValueError(f"out: expected 6 maps, got {len(out)}")
    for name, t in zip(STEP_OUT, out):
        _build.require(t, f"out.{name}", torch.float32, (h, w), dev)
        lo = t.data_ptr()
        for src in inputs:
            s0 = src.data_ptr()
            if lo < s0 + src.numel() * src.element_size() and \
                    s0 < lo + t.numel() * t.element_size():
                raise ValueError(f"out.{name} overlaps an input map")
    return out


def dynamic_step_open_cuda(frame: torch.Tensor, prev_sw: torch.Tensor,
                           prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                           tables: TriangulationTables, *, window: int = 21,
                           subpixel: bool = True,
                           scale_gradient: bool = True, robust: bool = True,
                           fov_min: float = 10.0, fov_max: float = 100.0,
                           frac_bits: int = 0,
                           out: Optional[StepMaps] = None) -> StepMaps:
    """The hand-written open-loop kernel (one launch). Inputs: u8 frame
    and float32 carried maps, contiguous (H, W) on one CUDA device.
    ``out``: six maps to write instead of fresh ones (a CUDA graph's
    static buffers), none overlapping an input. The host work before
    the launch is the span ``kernel.prep``."""
    with metrics.span("kernel.prep"):
        dev, h, w = _check_inputs(frame, prev_sw, prev_sb, prev_pu, tables,
                                  window, frac_bits)
        fbits = fast_frac_bits(frac_bits, window, w, subpixel)
        pu, sw, sb, z, x, y = out = _out_maps(
            out, (frame, prev_sw, prev_sb, prev_pu), h, w, dev)
        tri = _build.tri_array(tables.coeffs, fov_min, fov_max)
    _build.launch(
        "slc_dynamic_step", dev, frame.data_ptr(), prev_sw.data_ptr(),
        prev_sb.data_ptr(), prev_pu.data_ptr(), pu.data_ptr(), sw.data_ptr(),
        sb.data_ptr(), z.data_ptr(), x.data_ptr(), y.data_ptr(), h, w,
        window, int(subpixel), fbits, int(scale_gradient), int(robust), tri)
    dynamic_step_open_cuda.launches += 1
    return out


dynamic_step_open_cuda.launches = 0


@functools.lru_cache(maxsize=8)
def _tri_weights(h: int, w: int, win_u: int, win_v: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact in-image triangle weights wu (W,) and wv (H,), once per
    shape."""
    return (torch.from_numpy(tri_weights_1d(w, win_u)).to(device),
            torch.from_numpy(tri_weights_1d(h, win_v)).to(device))


def check_lock_args(period: float, win_u: int, win_v: int) -> None:
    """The lock parameters the kernels take: odd windows of 3..63 px and
    a positive finite period."""
    for name, win in (("win_u", win_u), ("win_v", win_v)):
        if win % 2 == 0 or not 3 <= win <= 63:
            raise ValueError(f"{name} must be odd in [3, 63], got {win}")
    if not (period > 0 and math.isfinite(period)):
        raise ValueError(f"period must be positive and finite, got "
                         f"{period}")


def lock_buffers(h: int, w: int, win_u: int, win_v: int, dev):
    """The lock launches' device scratch (DC, the correction map and the
    gate partials) and triangle weights."""
    scratch = torch.empty(
        _build.lib().slc_dynamic_step_lock_scratch(h, w, GATE_BAND),
        dtype=torch.float32, device=dev)
    return (scratch,) + _tri_weights(h, w, win_u, win_v, dev)


def gate_args(max_carrier_gradient: float) -> Tuple[int, float]:
    """(gate_on, threshold): 0 or inf turns the gate off, as in
    slc_tpu/ops/demod.py:204 (not the inverted reading of the TPU
    kernels)."""
    on = bool(max_carrier_gradient) and math.isfinite(max_carrier_gradient)
    return int(on), float(max_carrier_gradient) if on else 0.0


#: ``ablate`` of the locked step: where its launches stop.
_ABLATE = {"": 0, "track": 1, "dc": 2, "corr": 3}


def dynamic_step_lock_cuda(frame: torch.Tensor, prev_sw: torch.Tensor,
                           prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                           tables: TriangulationTables, *, window: int = 21,
                           subpixel: bool = True,
                           scale_gradient: bool = True, robust: bool = True,
                           fov_min: float = 10.0, fov_max: float = 100.0,
                           period: float = 12.0, win_u: int = 21,
                           win_v: int = 9, amp_floor: float = 8.0,
                           max_carrier_gradient: float = 2e-3,
                           frac_bits: int = 0,
                           ablate: str = "",
                           out: Optional[StepMaps] = None,
                           gates: Optional[torch.Tensor] = None) -> StepMaps:
    """The hand-written locked step (four launches, see the module
    note). ``max_carrier_gradient`` 0 or inf turns the gate off (see
    :func:`gate_args`). Gate bands are GATE_BAND rows, aligned to row 0.
    ``gates`` (float32, one per band, on the frame's device) receives the
    snap launch's decision per band: 1 where the correction was applied,
    0 where the carrier gate zeroed it.

    ``ablate`` (profiling only; the outputs are then garbage): "track",
    "dc" or "corr" stops after the track launch, after ``lock_dc`` or
    after ``lock_corr`` (C and S with the correction map and the gate
    partials), so that device timing splits the step by stage
    (slc_tpu/pallas/dynamic_lock.py:316-319). ``out`` as for
    :func:`dynamic_step_open_cuda`. The host work before the launch is
    the span ``kernel.prep``."""
    if ablate not in _ABLATE:
        raise ValueError(f"ablate must be one of {sorted(_ABLATE)}, got "
                         f"{ablate!r}")
    with metrics.span("kernel.prep"):
        dev, h, w = _check_inputs(frame, prev_sw, prev_sb, prev_pu, tables,
                                  window, frac_bits)
        check_lock_args(period, win_u, win_v)
        fbits = fast_frac_bits(frac_bits, window, w + 2 * win_u, subpixel)
        pu, sw, sb, z, x, y = out = _out_maps(
            out, (frame, prev_sw, prev_sb, prev_pu), h, w, dev)
        n_bands = -(-h // GATE_BAND)
        if gates is not None:
            _build.require(gates, "gates", torch.float32, (n_bands,), dev)
        scratch, wu, wv = lock_buffers(h, w, win_u, win_v, dev)
        tri = _build.tri_array(tables.coeffs, fov_min, fov_max)
    _build.launch(
        "slc_dynamic_step_lock", dev, frame.data_ptr(), prev_sw.data_ptr(),
        prev_sb.data_ptr(), prev_pu.data_ptr(), pu.data_ptr(), sw.data_ptr(),
        sb.data_ptr(), z.data_ptr(), x.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), wu.data_ptr(), wv.data_ptr(), h, w, window,
        int(subpixel), fbits, int(scale_gradient), int(robust),
        float(period), win_u, win_v, float(amp_floor),
        *gate_args(max_carrier_gradient), GATE_BAND, _ABLATE[ablate], tri)
    dynamic_step_lock_cuda.launches += 1
    if gates is not None:
        gates.copy_(scratch[-n_bands:])     # snap's decisions, last
    return out


dynamic_step_lock_cuda.launches = 0


def dynamic_step_open(frame: torch.Tensor, prev_sw: torch.Tensor,
                      prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                      tables: TriangulationTables, **kw) -> StepMaps:
    """Open-loop step: CPU tensors take the plain version, anything
    else the kernel. Returns (proj_u, strip_w, strip_b, z, x, y)."""
    fn = (dynamic_step_open_ref if frame.device.type == "cpu"
          else dynamic_step_open_cuda)
    return fn(frame, prev_sw, prev_sb, prev_pu, tables, **kw)


def dynamic_step_lock(frame: torch.Tensor, prev_sw: torch.Tensor,
                      prev_sb: torch.Tensor, prev_pu: torch.Tensor,
                      tables: TriangulationTables, **kw) -> StepMaps:
    """Phase-locked step: CPU tensors take the plain version, anything
    else the kernel. Returns (proj_u, strip_w, strip_b, z, x, y)."""
    fn = (dynamic_step_lock_ref if frame.device.type == "cpu"
          else dynamic_step_lock_cuda)
    return fn(frame, prev_sw, prev_sb, prev_pu, tables, **kw)
