"""One multigrid level of the spatial unwrap's preconditioner: the
descent (``mg_down``) and the ascent (``mg_up``) of ops.unwrap_spatial's
``vcycle`` with nu = 2; and its coarsest level (``mg_coarse``).

Source note. Replaces slc_tpu/pallas/mgsmooth.py:149 ``mg_down_pallas``
and :178 ``mg_up_pallas``. The CUDA kernels (csrc/mgsmooth.cu) work on
the same 2-D tiles with a 2-px halo in both directions (the TPU kernels
held whole rows and needed a row halo only), in two passes as the TPU
kernels make them: a sweep on tile+1, then on the tile ``mg_up``'s second
post-smooth or ``mg_down``'s e and r - A e. 128x40 tiles at full size
(128x8 on smaller levels), a thread four columns of a strip of rows, r,
dinv and wy in its registers, wx staged in 16-byte chunks; ``mg_up``
stages e too, ``mg_down`` makes sweep 1 from e = 0, (omega * dinv) * r,
from the registers and stages only its halo. Each moves 24 B/px of
device memory (mg_down: r, wy, wx, dinv in, e and res out; mg_up: e, r,
wy, wx, dinv in, e out) and is bound by it; the plain versions stream
~25 full-image maps per level. The kernels round every operation on its
own, in the plain path's association, so they match it bit for bit.

``mg_coarse`` is the port's own: it replaces no TPU kernel (slc_tpu
runs the coarsest level's sweeps as a ``lax.fori_loop`` in one XLA
program, slc_tpu/ops/unwrap_spatial.py:226-232). The plain version is
467 launches a visit (32 sweeps), 4 visits a preconditioner call at
1024x1280; the kernel is one launch, one thread block holding the level
in shared memory for all its sweeps (csrc/mgsmooth.cu). Its bound is
latency, 32 dependent block-wide sweeps, not its ~30 KB of traffic. It
rounds as the plain version does, so it matches it bit for bit.

``mg_down``, ``mg_up`` and ``mg_coarse`` dispatch on the device of ``r``:
CPU tensors take the plain PyTorch version, CUDA tensors the kernel (or
it raises). The caller, ``vcycle``, sends ``mg_down`` and ``mg_up`` only
levels with min(h, w) >= 256, smaller levels running the plain ops on
any device; and ``mg_coarse`` only coarsest levels that one block holds
(``ops.unwrap_spatial.coarse_kernel_fits``), a larger one running
``mg_coarse_ref``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops.unwrap_spatial import (MG_COARSE_SWEEPS, MG_OMEGA,
                                              _matvec, coarse_kernel_fits)


def mg_down_ref(r: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                dinv: torch.Tensor, omega: float = MG_OMEGA
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: two damped-Jacobi sweeps from e = 0, then
    the residual (slc_tpu/ops/unwrap_spatial.py:246-249). Returns
    (e, r - A e)."""
    e = omega * dinv * r
    e = e + omega * dinv * (r - _matvec(e, wy, wx))
    return e, r - _matvec(e, wy, wx)


def mg_up_ref(e: torch.Tensor, r: torch.Tensor, wy: torch.Tensor,
              wx: torch.Tensor, dinv: torch.Tensor,
              omega: float = MG_OMEGA) -> torch.Tensor:
    """Plain PyTorch version: two damped-Jacobi post-smooths
    (slc_tpu/ops/unwrap_spatial.py:261-262)."""
    for _ in range(2):
        e = e + omega * dinv * (r - _matvec(e, wy, wx))
    return e


def mg_coarse_ref(r: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                  dinv: torch.Tensor, omega: float = MG_OMEGA,
                  sweeps: int = MG_COARSE_SWEEPS) -> torch.Tensor:
    """Plain PyTorch version: ``sweeps`` damped-Jacobi sweeps from e = 0
    on the coarsest level (slc_tpu/ops/unwrap_spatial.py:226-232)."""
    e = omega * dinv * r              # first Jacobi sweep from e=0
    for _ in range(sweeps - 1):
        e = e + omega * dinv * (r - _matvec(e, wy, wx))
    return e


def _require_level(r, wy, wx, dinv, others=()) -> Tuple[int, int]:
    if r.ndim != 2 or r.numel() == 0:
        raise ValueError(f"r: expected a non-empty (h, w) tensor, got "
                         f"{tuple(r.shape)}")
    h, w = r.shape
    dev = r.device
    f32 = torch.float32
    for t, name in ((r, "r"), (dinv, "dinv")) + tuple(others):
        _build.require(t, name, f32, (h, w), dev)
    _build.require(wy, "wy", f32, (h - 1, w), dev)
    _build.require(wx, "wx", f32, (h, w - 1), dev)
    return h, w


def mg_down_cuda(r: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                 dinv: torch.Tensor, omega: float = MG_OMEGA
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hand-written descent kernel. ``r``, ``dinv`` (h, w), ``wy``
    (h-1, w), ``wx`` (h, w-1): contiguous f32 on one CUDA device. The
    host work before the launch is the span ``kernel.prep``."""
    with metrics.span("kernel.prep"):
        h, w = _require_level(r, wy, wx, dinv)
        e = torch.empty_like(r)
        res = torch.empty_like(r)
    _build.launch("slc_mg_down", r.device, r.data_ptr(), wy.data_ptr(),
                  wx.data_ptr(), dinv.data_ptr(), e.data_ptr(),
                  res.data_ptr(), h, w, float(omega))
    mg_down_cuda.launches += 1
    return e, res


mg_down_cuda.launches = 0


def mg_up_cuda(e: torch.Tensor, r: torch.Tensor, wy: torch.Tensor,
               wx: torch.Tensor, dinv: torch.Tensor,
               omega: float = MG_OMEGA) -> torch.Tensor:
    """The hand-written ascent kernel; shapes as :func:`mg_down_cuda`,
    ``e`` (h, w); its host work before the launch is ``kernel.prep``."""
    with metrics.span("kernel.prep"):
        h, w = _require_level(r, wy, wx, dinv, ((e, "e"),))
        out = torch.empty_like(r)
    _build.launch("slc_mg_up", r.device, e.data_ptr(), r.data_ptr(),
                  wy.data_ptr(), wx.data_ptr(), dinv.data_ptr(),
                  out.data_ptr(), h, w, float(omega))
    mg_up_cuda.launches += 1
    return out


mg_up_cuda.launches = 0


def mg_coarse_cuda(r: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                   dinv: torch.Tensor, omega: float = MG_OMEGA,
                   sweeps: int = MG_COARSE_SWEEPS) -> torch.Tensor:
    """The hand-written coarsest-level kernel; shapes as
    :func:`mg_down_cuda`, the level no larger than
    ``coarse_kernel_fits`` admits (else ValueError); its host work
    before the launch is ``kernel.prep``."""
    with metrics.span("kernel.prep"):
        h, w = _require_level(r, wy, wx, dinv)
        if not coarse_kernel_fits(h, w):
            raise ValueError(f"mg_coarse: a {h}x{w} level does not fit one "
                             f"thread block")
        e = torch.empty_like(r)
    _build.launch("slc_mg_coarse", r.device, r.data_ptr(), wy.data_ptr(),
                  wx.data_ptr(), dinv.data_ptr(), e.data_ptr(), h, w,
                  float(omega), int(sweeps))
    mg_coarse_cuda.launches += 1
    return e


mg_coarse_cuda.launches = 0


def mg_down(r, wy, wx, dinv, omega: float = MG_OMEGA):
    """Level descent: CPU tensors take the plain version, anything else
    the kernel."""
    if r.device.type == "cpu":
        return mg_down_ref(r, wy, wx, dinv, omega)
    return mg_down_cuda(r, wy, wx, dinv, omega)


def mg_up(e, r, wy, wx, dinv, omega: float = MG_OMEGA):
    """Level ascent: CPU tensors take the plain version, anything else
    the kernel."""
    if r.device.type == "cpu":
        return mg_up_ref(e, r, wy, wx, dinv, omega)
    return mg_up_cuda(e, r, wy, wx, dinv, omega)


def mg_coarse(r, wy, wx, dinv, omega: float = MG_OMEGA,
              sweeps: int = MG_COARSE_SWEEPS):
    """Coarsest level: CPU tensors take the plain version, anything else
    the kernel."""
    if r.device.type == "cpu":
        return mg_coarse_ref(r, wy, wx, dinv, omega, sweeps)
    return mg_coarse_cuda(r, wy, wx, dinv, omega, sweeps)
