"""Frame-0 absolute decode (PyTorch port of slc_tpu/pipeline.py:35-99).

:func:`decode_first_frame` is the reference's CalculateFirst
(CCalculation.cpp:171-206): Gray + phase-shift decode of the absolute
projector map, then triangulation. CUDA tensors run the hand-written
kernel (slc_tpu_torch.kernels.grayphase), CPU tensors the plain path.
The heterodyne and spatial decodes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.kernels.grayphase import grayphase_decode


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
    (slc_tpu/pipeline.py:94-96)."""
    x, y, z, proj_u = grayphase_decode(gray_images, phase_images, tables,
                                       cfg, min_modulation)
    return FrameResult(x=x, y=y, z=z, proj_u=proj_u)
