"""Projector-camera triangulation and back-projection (PyTorch port of
slc_tpu/ops/triangulate.py).

Reference behavior (DynaFrame/CCalculation.cpp:666-785):

  * P == 0 marks a hole -> z = 0 (CCalculation.cpp:678-682);
  * z = -(A - B*P) / (C - D*P) (CCalculation.cpp:686-687);
  * z outside [FOV_MIN, FOV_MAX] -> 0 (CCalculation.cpp:701-704);
  * x = z*(u-cx)/fx, y = z*(v-cy)/fy (CCalculation.cpp:756-771).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from slc_tpu_torch.calib import TriangulationTables


def triangulate_depth(proj_u: torch.Tensor, tables: TriangulationTables,
                      fov_min: float, fov_max: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H, W) absolute projector column -> (H, W) float32 depth.
    ``valid`` optionally adds an explicit validity mask to the
    reference's hole rule P == 0."""
    p = proj_u.float()
    denom = tables.c - tables.d * p
    z = (tables.b * p - tables.a) / denom
    hole = p == 0
    if valid is not None:
        hole = hole | ~valid
    out_of_fov = (z < fov_min) | (z > fov_max)
    return torch.where(hole | out_of_fov, torch.zeros_like(z), z)


def backproject(z: torch.Tensor, tables: TriangulationTables
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth -> camera-frame (x, y) maps via the pinhole model
    (CCalculation.cpp:756-771). Holes (z = 0) map to x = y = 0."""
    h, w = z.shape
    u = torch.arange(w, dtype=torch.float32, device=z.device)[None, :] \
        - tables.cx
    v = torch.arange(h, dtype=torch.float32, device=z.device)[:, None] \
        - tables.cy
    return z * (u / tables.fx), z * (v / tables.fy)


def triangulate_xyz(proj_u: torch.Tensor, tables: TriangulationTables,
                    fov_min: float, fov_max: float,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth + back-projection, the per-frame output of the pipeline
    (cf. CCalculation::FillCoordinate, CCalculation.cpp:666-785)."""
    z = triangulate_depth(proj_u, tables, fov_min, fov_max, valid)
    x, y = backproject(z, tables)
    return x, y, z
