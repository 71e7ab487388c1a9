"""Gray + phase-shift absolute decode (frame 0 and gray anchors).

Source note. Replaces slc_tpu/pallas/grayphase.py:152
``grayphase_decode_pallas``. The CUDA kernel (csrc/grayphase.cu) runs one
thread per pixel: Gray bits -> binary -> N-step atan2 -> Gray-parity
merge -> optional modulation mask -> triangulation, with C and D rebuilt
from their six bilinear coefficients instead of streamed. On the card it
is bound by device memory: it reads 2B+N u8 planes and writes 4 f32 maps,
32 B/px at the reference config (16 planes), and moves nothing else.

``grayphase_decode`` dispatches on the device of its inputs: CPU tensors
take the plain PyTorch version, CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops.gray import decode_gray
from slc_tpu_torch.ops.phase import decode_phase, modulation
from slc_tpu_torch.ops.triangulate import triangulate_xyz
from slc_tpu_torch.ops.unwrap import gray_assisted_merge

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def absolute_projector_map(gray_images: torch.Tensor,
                           phase_images: torch.Tensor,
                           cfg: SystemConfig) -> torch.Tensor:
    """Gray + phase-shift absolute decode of the projector map, plain
    PyTorch on the images' device: the reference's frame-0 hot path
    (FillFirstProjectorU, CCalculation.cpp:525-592;
    slc_tpu/pipeline.py:46-54)."""
    gray = decode_gray(gray_images, cfg.gray_bits, cfg.pro_w)
    phase = decode_phase(phase_images, cfg.phase_period)
    return gray_assisted_merge(gray, phase, cfg.gray_period,
                               cfg.phase_period)


def grayphase_decode_ref(gray_images: torch.Tensor,
                         phase_images: torch.Tensor,
                         tables: TriangulationTables, cfg: SystemConfig,
                         min_modulation: Optional[float] = None) -> Maps:
    """Plain PyTorch version: the composite path of
    slc_tpu/pipeline.py:92-98. Returns (x, y, z, proj_u)."""
    proj_u = absolute_projector_map(gray_images, phase_images, cfg)
    valid = None
    if min_modulation is not None:
        valid = modulation(phase_images) > min_modulation
        proj_u = torch.where(valid, proj_u, torch.zeros_like(proj_u))
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                              valid)
    return x, y, z, proj_u


def grayphase_decode_cuda(gray_images: torch.Tensor,
                          phase_images: torch.Tensor,
                          tables: TriangulationTables, cfg: SystemConfig,
                          min_modulation: Optional[float] = None) -> Maps:
    """The hand-written kernel. ``gray_images`` (2B, H, W) and
    ``phase_images`` (N, H, W): contiguous u8 on one CUDA device. The
    host work before the launch is the span ``kernel.prep``."""
    if cfg.phase_steps < 3:
        # With n < 3 every sine coefficient vanishes; 3 is also the
        # minimum for phase shifting (grayphase.py:167-171).
        raise ValueError(f"n_steps must be >= 3, got {cfg.phase_steps}")
    dev = gray_images.device
    h, w = cfg.cam_h, cfg.cam_w
    if h < 1 or w < 1:
        raise ValueError(f"empty image {h}x{w}")
    with metrics.span("kernel.prep"):
        _build.require(gray_images, "gray_images", torch.uint8,
                       (2 * cfg.gray_bits, h, w), dev)
        _build.require(phase_images, "phase_images", torch.uint8,
                       (cfg.phase_steps, h, w), dev)
        _build.require(tables.c, "tables.c", torch.float32, (h, w), dev)
        x, y, z, pu = (torch.empty((h, w), dtype=torch.float32, device=dev)
                       for _ in range(4))
        use_mod = min_modulation is not None
        min_mod_sq = float(min_modulation) ** 2 if use_mod else 0.0
        tri = _build.tri_array(tables.coeffs, cfg.fov_min, cfg.fov_max)
    _build.launch(
        "slc_grayphase", dev, gray_images.data_ptr(),
        phase_images.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
        pu.data_ptr(), h, w, cfg.gray_bits, cfg.phase_steps,
        float(cfg.gray_period), float(cfg.phase_period), int(use_mod),
        min_mod_sq, tri)
    grayphase_decode_cuda.launches += 1
    return x, y, z, pu


grayphase_decode_cuda.launches = 0


def grayphase_decode(gray_images: torch.Tensor, phase_images: torch.Tensor,
                     tables: TriangulationTables, cfg: SystemConfig,
                     min_modulation: Optional[float] = None) -> Maps:
    """Frame-0 absolute decode: CPU tensors take the plain version,
    anything else the kernel."""
    if gray_images.device.type == "cpu":
        return grayphase_decode_ref(gray_images, phase_images, tables, cfg,
                                    min_modulation)
    return grayphase_decode_cuda(gray_images, phase_images, tables, cfg,
                                 min_modulation)
