"""Multi-scan registration frontend: projective data association (PyTorch
port of slc_tpu/fusion_frontend.py; BASELINE config 5's frontend, no
reference equivalent: the reference is single-scan).

Connects the bundle adjustment backend (slc_tpu_torch.fusion) to depth
maps. Landmarks are a pixel grid of every scan's depth map back-projected
to world; each scan's observation of a landmark is found by projecting it
into that scan's camera with the current pose estimate, bilinearly
sampling the scan's depth map, and back-projecting the sampled depth
(projective, ICP-style association). Alternating associate -> solve
rounds is projective ICP over all scans jointly. The scans are one batch
axis of every tensor (slc_tpu maps over them with ``vmap``).

Spans (:mod:`slc_tpu_torch.metrics`, recorded only under a profiler):
``fusion.register`` (a whole :func:`register_scans`) and, inside it,
``fusion.associate``, ``fusion.p2l_gn`` and ``fusion.anchor_gauge``;
counters ``fusion.calls``, ``fusion.gn_steps`` and ``fusion.p2l_kernel``
(the steps that ran as the kernels of :mod:`slc_tpu_torch.kernels.p2l`;
both in :func:`fusion._fuse_scans_p2l`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Tuple

import numpy as np
import torch

from slc_tpu_torch import cloud, fusion, metrics, se3
from slc_tpu_torch.calib import resolve_device
from slc_tpu_torch.fusion import highest_precision


def _grid(h: int, w: int, step: int, device):
    """Rows and columns of the sampled grid: every ``step``-th pixel,
    offset by step // 2; (H // step) x (W // step) points."""
    ys = torch.arange(0, h - (h % step), step, device=device) + step // 2
    xs = torch.arange(0, w - (w % step), step, device=device) + step // 2
    return ys, xs


def backproject_grid(depth: torch.Tensor, cam_k: torch.Tensor, step: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample every ``step``-th pixel: returns (points (L, 3) in the
    camera frame, valid (L,)). L = (H//step) * (W//step)."""
    h, w = depth.shape
    ys, xs = _grid(h, w, step, depth.device)
    z = depth[ys[:, None], xs[None, :]]
    u = (xs[None, :] - cam_k[0, 2]) / cam_k[0, 0]
    v = (ys[:, None] - cam_k[1, 2]) / cam_k[1, 1]
    pts = torch.stack([u.expand(z.shape) * z, v.expand(z.shape) * z, z],
                      dim=-1)
    return pts.reshape(-1, 3), (z > 0).reshape(-1)


def grid_points_normals(depth: torch.Tensor, cam_k: torch.Tensor,
                        step: int, normal_radius: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(points (..., L, 3), normals (..., L, 3), valid (..., L)) at the
    sampled grid of (..., H, W) depth maps. A depth that is not finite (a
    decode's 0 / 0) is a hole, as 0 is: its point is the camera centre,
    so no NaN reaches a landmark, and its residuals are masked to 0.

    ``normal_radius`` 0 is slc_tpu's normal, the neighbour cross product
    (down - c) x (right - c) (cloud.cloud_normals): slc_tpu builds the
    whole cloud and its normals and then samples the grid; this computes
    the same arithmetic at the grid pixels and at their right and down
    neighbours only (wrapping at the last column and row, as the roll
    there does). A radius r > 0 departs from slc_tpu: central
    differences (down - up) x (right - left) between the pixels r away,
    which leave the point's own depth out. A decoded map's depth error
    (~0.02 at 1280 columns, where neighbours lie ~0.1 apart) then no
    longer turns the normal towards the point's own error, which biases
    every residual and drives the registration away from the true
    poses. A stencil that leaves the image is masked."""
    h, w = depth.shape[-2:]
    ys, xs = _grid(h, w, step, depth.device)
    yy, xx = ys[:, None], xs[None, :]
    lo, hi = (normal_radius, normal_radius) if normal_radius else (0, 1)
    xl, xr = (xx - lo) % w, (xx + hi) % w
    yu, yd = (yy - lo) % h, (yy + hi) % h
    at = ((yy, xx), (yy, xl), (yy, xr), (yu, xx), (yd, xx))
    z, z_l, z_r, z_u, z_d = (torch.where(torch.isfinite(d), d, 0.0)
                             for d in (depth[..., i, j] for i, j in at))
    k = (cam_k[0, 0], cam_k[1, 1], cam_k[0, 2], cam_k[1, 2])

    def pts_at(zz, col, row):
        return cloud.pinhole_points(zz, col.float(), row.float(), *k)

    c = pts_at(z, xx, yy)
    n = torch.linalg.cross(pts_at(z_d, xx, yd) - pts_at(z_u, xx, yu),
                           pts_at(z_r, xr, yy) - pts_at(z_l, xl, yy),
                           dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(
        1e-20)
    ok = ((z > 0) & (z_l > 0) & (z_r > 0) & (z_u > 0) & (z_d > 0)
          & (yy >= lo) & (xx >= lo) & (yy < h - hi) & (xx < w - hi))
    n = torch.where(ok[..., None], n, 0.0)
    # Depth-discontinuity filter: cross-product normals at occlusion
    # edges are garbage; drop grid points whose depth steps to a
    # neighbour of the stencil exceed 2% of the local depth.
    step_z = torch.stack([(q - z).abs() for q in (z_l, z_r, z_u, z_d)])
    edge = step_z.amax(dim=0) > 0.02 * z.clamp_min(1e-6)
    lead = depth.shape[:-2]
    return (c.reshape(*lead, -1, 3), n.reshape(*lead, -1, 3),
            (ok & ~edge).reshape(*lead, -1))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as slc_tpu's fused XLA
    loop computes the projection (a float64 product of two float32 is
    exact). The depth gradient at occlusion edges turns the last bit of a
    pixel coordinate into up to 1.5e-4 scene units of observation."""
    return (a.double() * b.double() + c.double()).float()


def _bilinear(depth: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hole-aware bilinear depth sample of (S, H, W) maps at continuous
    (x, y) (S, N); returns (z, valid). A sample is valid only if all four
    corners are valid and in bounds.

    The bounds test and the clamp act on the float corner: a landmark
    behind a camera or far off-image projects to a huge or infinite
    coordinate, which slc_tpu's int32 convert saturates, and whose cast
    to an integer is undefined here."""
    s, h, w = depth.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = torch.nan_to_num(x0).clamp(0, w - 2)
    y0c = torch.nan_to_num(y0).clamp(0, h - 2)
    fx = x - x0c
    fy = y - y0c
    flat = depth.reshape(s, -1)
    i00 = y0c.long() * w + x0c.long()

    def at(i):
        return torch.gather(flat, 1, i)
    z00, z01, z10, z11 = at(i00), at(i00 + 1), at(i00 + w), at(i00 + w + 1)
    ok = inb & (z00 > 0) & (z01 > 0) & (z10 > 0) & (z11 > 0)
    z = (z00 * (1 - fx) * (1 - fy) + z01 * fx * (1 - fy)
         + z10 * (1 - fx) * fy + z11 * fx * fy)
    return z, ok


@highest_precision
def associate_projective(depths: torch.Tensor, cam_k: torch.Tensor,
                         rot: torch.Tensor, trans: torch.Tensor,
                         grid_step: int = 8, max_depth_err: float = 1.0,
                         normal_radius: int = 0):
    """Build (obs (S, L, 3), mask (S, L), landmarks (L, 3), normals (L,
    3)) from (S, H, W) depth maps, intrinsics, and current
    world_from_scan poses.

    Landmarks are the union of every scan's back-projected pixel grid
    (L = S * grid points): a chain of pairwise-overlapping scans stays
    connected even when the ends share no common surface. Landmark
    normals (owner scan's surface normal, rotated to world) are returned
    for the point-to-plane solve. The pose transforms contract against
    3x3 rotations at landmark magnitudes of ~60 scene units, so they run
    at full float32 precision (fusion.full_f32). ``normal_radius``: that
    of :func:`grid_points_normals`."""
    pts, nrm, valid = grid_points_normals(depths, cam_k, grid_step,
                                          normal_radius)
    landmarks = se3.apply(rot, trans[:, None, :], pts).reshape(-1, 3)
    normals = (nrm @ rot.transpose(-1, -2)).reshape(-1, 3)
    valid0 = valid.reshape(-1)

    r_inv, t_inv = se3.invert(rot, trans)
    p_cam = se3.apply(r_inv, t_inv[:, None, :], landmarks)   # (S, L, 3)
    z_pred = p_cam[..., 2]
    zc = z_pred.clamp_min(1e-6)
    u = _fma(p_cam[..., 0] / zc, cam_k[0, 0], cam_k[0, 2])
    v = _fma(p_cam[..., 1] / zc, cam_k[1, 1], cam_k[1, 2])
    z_meas, ok = _bilinear(depths, u, v)
    ok = (ok & valid0 & (z_pred > 0)
          & ((z_meas - z_pred).abs() < max_depth_err))
    scale = z_meas / zc
    obs = torch.where(ok[..., None], p_cam * scale[..., None], 0.0)
    # Exclude self-observations: a scan trivially re-observes its own
    # landmarks at zero residual for its CURRENT pose, which under the
    # pose-only point-to-plane solve would anchor every pose to its
    # initial (wrong) value. Only cross-scan constraints carry
    # registration information.
    s = depths.shape[0]
    scans = torch.arange(s, device=depths.device)
    owner = scans.repeat_interleave(landmarks.shape[0] // s)   # (L,)
    mask = ok & (owner[None, :] != scans[:, None])
    return obs, mask.to(depths.dtype), landmarks, normals


def _anchor_gauge_align(rot, trans, obs, mask, landmarks, normals,
                        n_anchor_landmarks):
    """:func:`anchor_gauge_align`, returning (rot, trans, info)."""
    g = n_anchor_landmarks
    s = rot.shape[0]
    dev, dt_ = rot.device, rot.dtype
    # World-frame predicted points for observations of anchor landmarks
    # by non-anchor scans.
    pred = (torch.einsum("sij,slj->sli", rot, obs[:, :g])
            + trans[:, None, :])                          # (S, g, 3)
    not_anchor = (torch.arange(s, device=dev) > 0).to(dt_)
    m = mask[:, :g] * not_anchor[:, None]                 # exclude scan 0
    x = landmarks[None, :g]
    n = normals[None, :g].expand(pred.shape)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    r_acc = torch.eye(3, dtype=dt_, device=dev)
    t_acc = torch.zeros(3, dtype=dt_, device=dev)
    info = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(3):
        p = torch.einsum("ij,slj->sli", r_acc, pred) + t_acc
        res = torch.sum(n * (p - x), dim=-1)
        jw = torch.linalg.cross(p, n, dim=-1)             # d(res)/d(omega)
        j = torch.cat([jw, n], dim=-1)
        jm = j * m[..., None]
        h = torch.einsum("sli,slj->ij", jm, j)
        b = -torch.einsum("sli,sl->i", jm, res)
        h = h + 1e-6 * torch.trace(h) / 6.0 * eye6 + 1e-12 * eye6
        step, i = torch.linalg.solve_ex(h, b)
        info = info + i
        dr = se3.exp_so3(step[:3])
        r_acc, t_acc = dr @ r_acc, torch.einsum("ij,j->i", dr, t_acc) \
            + step[3:]
    new_rot = rot.clone()
    new_trans = trans.clone()
    new_rot[1:] = r_acc @ rot[1:]
    new_trans[1:] = torch.einsum("ij,sj->si", r_acc, trans[1:]) + t_acc
    return new_rot, new_trans, info


@highest_precision
def anchor_gauge_align(rot: torch.Tensor, trans: torch.Tensor,
                       obs: torch.Tensor, mask: torch.Tensor,
                       landmarks: torch.Tensor, normals: torch.Tensor,
                       n_anchor_landmarks: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid gauge re-registration to the anchor scan.

    The consensus p2l rounds make the scans MUTUALLY consistent, but the
    common-mode rigid offset of the whole ensemble relative to scan 0 is
    only pulled by the ~1/S of observations that reference scan-0
    landmarks, and stalls at a nonzero fixed point. This step estimates
    ONE SE(3) transform G from ALL non-anchor observations of
    anchor-owned landmarks (point-to-plane GN on 6 DoF, 3 iterations) and
    applies it to every non-anchor pose: the ensemble's internal
    registration is untouched (rigid motion), and the gauge lands on
    scan 0."""
    new_rot, new_trans, info = _anchor_gauge_align(
        rot, trans, obs, mask, landmarks, normals, n_anchor_landmarks)
    fusion.check_info(info, "anchor_gauge_align")
    return new_rot, new_trans


@contextlib.contextmanager
def _timed(timings: Optional[dict], name: str, dev: torch.device):
    """Mark the block as the span ``fusion.<name>``; and add its wall
    time in ms, its device work included, to ``timings[name]``; nothing
    more without ``timings``."""
    with metrics.span("fusion." + name):
        if timings is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[name] = timings.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)


@highest_precision
def register_scans(depths, cam_k, init_rot, init_trans, rounds: int = 4,
                   gn_iters: int = 5, grid_step: int = 8,
                   max_depth_err: float = 1.0, anchor_gauge: bool = True,
                   device="cuda", timings: Optional[dict] = None,
                   normal_radius: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint multi-scan registration: alternate projective association
    with point-to-plane bundle adjustment (point-to-point slides
    tangentially on smooth surfaces; the normal-projected residual does
    not), then re-register the ensemble's gauge to the anchor scan
    (:func:`anchor_gauge_align`; ``anchor_gauge=False`` skips it).

    ``depths`` (S, H, W), ``cam_k`` (3, 3), ``init_rot`` (S, 3, 3) and
    ``init_trans`` (S, 3), arrays or tensors, are taken to ``device`` as
    float32. Given a ``timings`` dict, the wall time of each stage in ms
    (device work included: the device is synchronised after each) is
    summed into it under "associate", "p2l_gn" and "anchor_gauge".
    Returns refined world_from_scan (rot (S,3,3), trans (S,3)) on
    ``device``; the solves' failure codes are checked once, at the end.
    ``normal_radius``: that of :func:`grid_points_normals` (0,
    slc_tpu's method, by default). Its host time, that read-back
    included, is the span ``fusion.register``; it adds 1 to
    ``fusion.calls``."""
    with metrics.span("fusion.register"):
        metrics.count("fusion.calls")
        dev = resolve_device(device)
        depths, cam_k, rot, trans = (
            a.to(device=dev, dtype=torch.float32)
            if isinstance(a, torch.Tensor)
            else torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
            for a in (depths, cam_k, init_rot, init_trans))
        info = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(rounds):
            with _timed(timings, "associate", dev):
                obs, mask, lm, normals = associate_projective(
                    depths, cam_k, rot, trans, grid_step, max_depth_err,
                    normal_radius)
            with _timed(timings, "p2l_gn", dev):
                rot, trans, _, i = fusion._fuse_scans_p2l(
                    obs, mask, normals, rot, trans, lm, gn_iters, 1e-3)
            info = info + i
        if anchor_gauge:
            h, w = depths.shape[1:]
            g = (h // grid_step) * (w // grid_step)
            with _timed(timings, "associate", dev):
                obs, mask, lm, normals = associate_projective(
                    depths, cam_k, rot, trans, grid_step, max_depth_err,
                    normal_radius)
            with _timed(timings, "anchor_gauge", dev):
                rot, trans, i = _anchor_gauge_align(rot, trans, obs, mask,
                                                    lm, normals, g)
            info = info + i
        fusion.check_info(info, "register_scans")
        return rot, trans
