"""Projector-camera calibration and triangulation tables (PyTorch port of
slc_tpu/calib.py).

The reference loads ``CamMat / ProMat / R / T`` from an OpenCV YAML file
(DynaFrame/CCalculation.cpp:124-132) and precomputes a per-pixel rational
triangulation: scalars ``A, B`` and per-pixel maps ``C(v,u), D(v,u)``
(DynaFrame/CCalculation.cpp:135-166) such that

    z(v, u) = -(A - B * P) / (C(v,u) - D(v,u) * P)

where ``P`` is the absolute projector column seen at camera pixel (v, u).
The tables are built in float64 numpy on the host with the arithmetic of
slc_tpu/calib.py:113-132, then rounded to float32 once, so they are
bit-identical to the JAX package's tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Pinhole projector-camera calibration (slc_tpu/calib.py:28-76).

    Float32 CPU tensors, as slc_tpu stores float32 (calib.py:44-50), so
    every float64 host computation from a Calibration and every synth
    render sees the same rounded values in both packages.
    """

    cam_k: torch.Tensor    # (3, 3) camera intrinsics
    pro_k: torch.Tensor    # (3, 3) projector intrinsics
    rot: torch.Tensor      # (3, 3) camera->projector rotation
    trans: torch.Tensor    # (3,)   camera->projector translation

    @staticmethod
    def from_numpy(cam_k, pro_k, rot, trans) -> "Calibration":
        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32).copy())
        return Calibration(cam_k=f32(cam_k), pro_k=f32(pro_k),
                           rot=f32(rot), trans=f32(trans).reshape(3))

    @staticmethod
    def reference_example() -> "Calibration":
        """The example calibration shipped with the reference
        (DynaFrame/Result.yml:2-28)."""
        cam_k = np.array([[1213.8714552009253, 0.0, 319.5],
                          [0.0, 1215.9945377703152, 255.5],
                          [0.0, 0.0, 1.0]])
        pro_k = np.array([[2028.8057545415668, 0.0, 619.58898841564314],
                          [0.0, 2031.9614890033101, 665.20739361244557],
                          [0.0, 0.0, 1.0]])
        rot = np.array([
            [0.99143473372566937, -0.012723342704854930, 0.12998186532253575],
            [0.025847502916207063, 0.99467300669012182, -0.099787355687128362],
            [-0.12801982407153850, 0.10229235705783506, 0.98648223416959957]])
        trans = np.array([-3.1747826732013134, -0.92770189525198721,
                          3.9430125669975382])
        return Calibration.from_numpy(cam_k, pro_k, rot, trans)

    def pro_mat(self) -> np.ndarray:
        """3x4 projector projection P = K_p [R | T]
        (DynaFrame/CCalculation.cpp:141-145), float64 on host."""
        rt = np.concatenate(
            [np.asarray(self.rot, np.float64),
             np.asarray(self.trans, np.float64).reshape(3, 1)], axis=1)
        return np.asarray(self.pro_k, np.float64) @ rt


@dataclasses.dataclass(frozen=True)
class TriangulationTables:
    """Per-pixel rational-triangulation tables (slc_tpu/calib.py:79-105),
    normalized by fx*fy so float32 operands stay O(1e3):

        A = fx*fy*P03            B = fx*fy*P23
        C = (u-cx)*fy*P00 + (v-cy)*fx*P01 + fx*fy*P02
        D = (u-cx)*fy*P20 + (v-cy)*fx*P21 + fx*fy*P22

    The tensors live on the device the tables were built for. ``coeffs``
    keeps the same scalars as host floats for the kernels' launch
    arguments — (A, B, fx, fy, cx, cy) and C's and D's bilinear
    coefficients (cu, cv, c0, du, dv, d0) from :func:`lin_coeffs` — so a
    launch never reads the device.
    """

    a: torch.Tensor        # scalar ()
    b: torch.Tensor        # scalar ()
    c: torch.Tensor        # (H, W)
    d: torch.Tensor        # (H, W)
    fx: torch.Tensor       # scalar camera focal lengths / principal point,
    fy: torch.Tensor       # for back-projection (CCalculation.cpp:756-771)
    cx: torch.Tensor
    cy: torch.Tensor
    coeffs: Tuple[float, ...]

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   device="cuda") -> "TriangulationTables":
        """From the JAX package's table fields as numpy arrays (keys
        a, b, c, d, fx, fy, cx, cy); values are kept as float32. On the
        card unless ``device`` says otherwise (see
        :func:`resolve_device`)."""
        device = resolve_device(device)
        host = {k: np.asarray(arrays[k], np.float32)
                for k in ("a", "b", "c", "d", "fx", "fy", "cx", "cy")}
        scal = tuple(float(host[k]) for k in ("a", "b", "fx", "fy",
                                               "cx", "cy"))
        coeffs = scal + lin_coeffs(host["c"]) + lin_coeffs(host["d"])
        dev = {k: torch.from_numpy(v.copy()).to(device)
               for k, v in host.items()}
        return TriangulationTables(coeffs=coeffs, **dev)


def lin_coeffs(m: np.ndarray) -> Tuple[float, float, float]:
    """(ku, kv, k0) of an exactly-bilinear float32 (H, W) map
    m(v, u) = ku*u + kv*v + k0 (slc_tpu/pallas/mathx.py:482-498), in the
    same float32 arithmetic: slopes across the FULL span, so the
    rebuilt map stays within ~2 ulp of the stored table everywhere."""
    m = np.asarray(m, np.float32)
    h, w = m.shape
    k0 = m[0, 0]
    ku = (m[0, w - 1] - k0) * np.float32(1.0 / (w - 1))
    kv = (m[h - 1, 0] - k0) * np.float32(1.0 / (h - 1))
    return float(ku), float(kv), float(k0)


def build_tables(calib: Calibration, cam_h: int, cam_w: int,
                 device="cuda") -> TriangulationTables:
    """Host-side float64 construction of the triangulation tables, cast
    to float32 for ``device``, the card unless the caller asks for the
    CPU (slc_tpu/calib.py:108-132, same arithmetic, so bit-identical)."""
    cam_k = np.asarray(calib.cam_k, np.float64)
    p = calib.pro_mat()
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]

    u = np.arange(cam_w, dtype=np.float64)[None, :] - cx    # (1, W)
    v = np.arange(cam_h, dtype=np.float64)[:, None] - cy    # (H, 1)

    norm = fx * fy
    c = (u * fy * p[0, 0] + v * fx * p[0, 1]) / norm + p[0, 2]
    d = (u * fy * p[2, 0] + v * fx * p[2, 1]) / norm + p[2, 2]
    return TriangulationTables.from_numpy(
        {"a": p[0, 3], "b": p[2, 3],
         "c": np.broadcast_to(c, (cam_h, cam_w)),
         "d": np.broadcast_to(d, (cam_h, cam_w)),
         "fx": fx, "fy": fy, "cx": cx, "cy": cy}, device)


def synthetic_calibration(baseline: float = 20.0,
                          z_work: float = 50.0,
                          cam_f: float = 600.0,
                          pro_f: float = 400.0,
                          cam_h: int = 480, cam_w: int = 640,
                          pro_h: int = 480, pro_w: int = 640) -> Calibration:
    """A well-conditioned synthetic rig (slc_tpu/calib.py:135-157):
    projector displaced along +x by ``baseline`` (scene units) and toed
    in about +y so both optical axes intersect at depth ``z_work`` on
    the camera axis."""
    cam_k = np.array([[cam_f, 0.0, (cam_w - 1) / 2.0],
                      [0.0, cam_f, (cam_h - 1) / 2.0],
                      [0.0, 0.0, 1.0]])
    pro_k = np.array([[pro_f, 0.0, (pro_w - 1) / 2.0],
                      [0.0, pro_f, (pro_h - 1) / 2.0],
                      [0.0, 0.0, 1.0]])
    th = -np.arctan2(baseline, z_work)
    rot = np.array([[np.cos(th), 0.0, -np.sin(th)],
                    [0.0, 1.0, 0.0],
                    [np.sin(th), 0.0, np.cos(th)]])
    trans = -rot @ np.array([baseline, 0.0, 0.0])
    return Calibration.from_numpy(cam_k, pro_k, rot, trans)


def project_to_projector(calib: Calibration,
                         xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host/float64 helper: project camera-frame points (..., 3) through
    the projector, returning (col, row) continuous projector coords."""
    p = calib.pro_mat()
    xyz = np.asarray(xyz, np.float64)
    h = xyz @ p[:, :3].T + p[:, 3]
    return h[..., 0] / h[..., 2], h[..., 1] / h[..., 2]
