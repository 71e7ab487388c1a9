"""Minimal SE(3) utilities for multi-scan registration, float32 (PyTorch
port of slc_tpu/se3.py).

No reference equivalent (the reference is single-scan); used by
slc_tpu_torch.fusion's bundle adjustment.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w.unbind(dim=-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    k = hat(w)
    k2 = k @ k
    th = theta.clamp_min(1e-12)
    a = torch.sin(th) / th
    b = (1.0 - torch.cos(th)) / (th * th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    # Small-angle limit: a -> 1, b -> 1/2.
    small = theta < 1e-6
    a = torch.where(small, 1.0, a)
    b = torch.where(small, 0.5, b)
    return eye + a * k + b * k2


def exp_se3(xi: torch.Tensor) -> tuple:
    """(..., 6) twist [t, w] -> (R, t) with the first-order coupling
    (V ~ I; adequate for Gauss-Newton increments)."""
    return exp_so3(xi[..., 3:]), xi[..., :3]


def apply(rot: torch.Tensor, trans: torch.Tensor,
          pts: torch.Tensor) -> torch.Tensor:
    """R p + t with broadcasting over leading axes of pts."""
    return pts @ rot.transpose(-1, -2) + trans


def compose(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): first apply 2, then 1."""
    return r1 @ r2, apply(r1, t1, t2)


def invert(rot, trans):
    rt = rot.transpose(-1, -2)
    return rt, -torch.einsum("...ij,...j->...i", rt, trans)
