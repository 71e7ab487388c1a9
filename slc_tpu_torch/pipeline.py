"""Frame-0 absolute decodes (PyTorch port of slc_tpu/pipeline.py).

* :func:`absolute_projector_map` is the Gray + phase decode of the
  projector map alone, plain PyTorch on any device;
* :func:`decode_first_frame` is the reference's CalculateFirst
  (CCalculation.cpp:171-206): Gray + phase-shift decode of the absolute
  projector map, then triangulation;
* :func:`decode_heterodyne_frame` is the multi-frequency variant (no Gray
  codes; absent in the reference);
* :func:`decode_spatial_frame` decodes one fringe frequency and unwraps
  it spatially (absolute up to one global period offset).

CUDA tensors run the hand-written kernels (slc_tpu_torch.kernels), CPU
tensors the plain path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.kernels.bilateral import bilateral_filter
from slc_tpu_torch.kernels.grayphase import (  # noqa: F401 (re-exported)
    absolute_projector_map, grayphase_decode)
from slc_tpu_torch.kernels.heterodyne import heterodyne_decode
from slc_tpu_torch.ops.phase import decode_phase, modulation
from slc_tpu_torch.ops.triangulate import triangulate_xyz
from slc_tpu_torch.ops.unwrap_spatial import unwrap_spatial


@dataclasses.dataclass(frozen=True)
class FrameResult:
    """Per-frame reconstruction output (cf. the m_x/m_y/m_zMat arrays,
    CCalculation.cpp:102-121)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    proj_u: Optional[torch.Tensor]


def decode_first_frame(gray_images: torch.Tensor,
                       phase_images: torch.Tensor,
                       tables: TriangulationTables, cfg: SystemConfig,
                       min_modulation: Optional[float] = None
                       ) -> FrameResult:
    """Frame-0 absolute decode + triangulation. ``min_modulation``
    optionally masks pixels of low fringe modulation; masked pixels get
    P == 0 as well as z == 0, so they read as holes downstream
    (slc_tpu/pipeline.py:94-96). Its host time is the span
    ``decode.first``."""
    with metrics.span("decode.first"):
        x, y, z, proj_u = grayphase_decode(gray_images, phase_images,
                                           tables, cfg, min_modulation)
        return FrameResult(x=x, y=y, z=z, proj_u=proj_u)


def decode_heterodyne_frame(fringe_images: torch.Tensor,
                            tables: TriangulationTables, cfg: SystemConfig,
                            het: HeterodyneConfig,
                            min_modulation: Optional[float] = 2.0
                            ) -> FrameResult:
    """Multi-frequency heterodyne absolute decode + triangulation
    (slc_tpu/pipeline.py:102-154): ``het.num_images`` fringe images,
    finest frequency first, no Gray codes. Pixels whose smallest
    modulation over the frequencies is not above ``min_modulation`` are
    holes (P == 0, z == 0). Its host time is the span ``decode.first``."""
    with metrics.span("decode.first"):
        x, y, z, proj_u = heterodyne_decode(fringe_images, tables, cfg, het,
                                            min_modulation)
        return FrameResult(x=x, y=y, z=z, proj_u=proj_u)


def decode_spatial_frame(fringe_images: torch.Tensor,
                         tables: TriangulationTables, cfg: SystemConfig,
                         period: float,
                         anchor: Optional[torch.Tensor] = None,
                         min_modulation: float = 2.0,
                         unwrap_iters: int = 300,
                         filter_depth: bool = True,
                         mg: bool = True) -> FrameResult:
    """Single-frequency decode with quality-guided spatial unwrapping
    (slc_tpu/pipeline.py:157-193): N-step decode -> modulation quality ->
    weighted-LS spatial unwrap -> triangulate -> hole-aware bilateral
    depth filter (z only; x and y come from the unfiltered depth).

    ``anchor`` optionally pins the global fringe order (e.g. a previous
    absolute map); without it the result is right up to one global period
    offset. ``mg`` selects the multigrid-preconditioned CG (default).
    Its host time is the span ``decode.spatial``."""
    with metrics.span("decode.spatial"):
        wrapped = decode_phase(fringe_images, period)
        quality = modulation(fringe_images)
        proj_u = unwrap_spatial(wrapped, period, quality=quality,
                                max_iters=unwrap_iters, anchor=anchor, mg=mg)
        valid = quality > min_modulation
        proj_u = torch.where(valid, proj_u, torch.zeros_like(proj_u))
        x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                                  valid)
        if filter_depth:
            z = bilateral_filter(z)       # depthMapUtils.cpp:179 behaviour
        return FrameResult(x=x, y=y, z=z, proj_u=proj_u)
