"""Plain PyTorch reference of the multi-view registration: a frozen copy of
the math of the port's ``fusion_frontend.register_scans`` (projective
association, point-to-plane Gauss-Newton over the poses, the anchor
gauge), with every floating-point operation in one ``dt``: float32 is the
configuration's stated precision, bfloat16 the control's. It imports
nothing of the program and no kernel.

Matrix products are IEEE float32 unless ``tf32`` is given: inside
:func:`register` ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are False (True for the TF32
control), and the caller's settings are restored on exit.

The method is point-to-plane registration of range images (Chen &
Medioni, Image and Vision Computing 10(3):145-155, 1992) over all views
jointly. Departures from that paper, all the port's:

- association is projective: a landmark is projected into a view with
  its current pose, the view's depth map sampled bilinearly (all four
  corners depth, inside the image) and back-projected; pairs whose
  depths differ by ``max_depth_err`` or more are dropped. The paper
  intersects the normal line with the other surface.
- landmarks are every view's grid of pixels (every ``grid_step``-th,
  offset by half a step) back-projected to the world at the poses of the
  round; normals are the owner's central differences (down - up) x
  (right - left) between the pixels ``normal_radius`` away, which
  leave the point's own depth out (radius 0: slc_tpu's (down - c) x
  (right - c) with the neighbours 1 px away; the paper fits a surface),
  dropped at depth steps over 2% of the depth. A view never observes
  its own landmarks (self-observations are excluded).
- the problem is all views at once, with the landmarks held fixed in a
  round: each Gauss-Newton step solves one 6x6 system per view, the
  rotation's lever taken about the centroid of the view's observations;
  residuals are Huber-weighted (delta 3 times their mean magnitude);
  Levenberg-Marquardt damping 1e-3 of the diagonal; view 0 is frozen
  (the gauge). The paper registers one pair with plain least squares.
- after the rounds, one rigid transform of all views but view 0 (3
  point-to-plane steps on the observations of view 0's landmarks)
  re-registers the ensemble to view 0 (the anchor gauge).
- a depth that is 0 or not finite is a hole.

bfloat16 has no LAPACK solve: the 6x6 systems are solved in float32 from
the ``dt``-rounded matrices, the solution rounded back to ``dt``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _matmul(tf32: bool):
    """IEEE float32 matrix products inside the block (TF32 ones with
    ``tf32``), the caller's settings restored on exit."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[2]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[0])


def _solve(a: torch.Tensor, b: torch.Tensor):
    """(solution, info) of a x = b, in float32 where ``a`` is of a lower
    precision, rounded back to it."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve_ex(a, b)
    x, info = torch.linalg.solve_ex(a.float(), b.float())
    return x.to(a.dtype), info


# --- SE(3) ------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(dim=-1)
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, the small-angle limit below 1e-6 rad."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    k = hat(w)
    k2 = k @ k
    th = theta.clamp_min(1e-12)
    a = torch.sin(th) / th
    b = (1.0 - torch.cos(th)) / (th * th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    small = theta < 1e-6
    a = torch.where(small, 1.0, a)
    b = torch.where(small, 0.5, b)
    return eye + a * k + b * k2


def apply(rot: torch.Tensor, trans: torch.Tensor,
          pts: torch.Tensor) -> torch.Tensor:
    return pts @ rot.transpose(-1, -2) + trans


def invert(rot: torch.Tensor, trans: torch.Tensor):
    rt = rot.transpose(-1, -2)
    return rt, -torch.einsum("...ij,...j->...i", rt, trans)


# --- association ------------------------------------------------------

def grid(h: int, w: int, step: int, device):
    ys = torch.arange(0, h - (h % step), step, device=device) + step // 2
    xs = torch.arange(0, w - (w % step), step, device=device) + step // 2
    return ys, xs


def grid_points_normals(depth: torch.Tensor, cam_k: torch.Tensor,
                        step: int, normal_radius: int = 0):
    """(points (S, G, 3), normals (S, G, 3), valid (S, G)) of (S, H, W)
    maps at their G grid pixels: camera-frame points, unit normals
    (down - up) x (right - left) between the pixels ``normal_radius``
    away (radius 0: up and left are the point, down and right 1 px
    away), valid where the point and its stencil are depth inside the
    image, and not at a depth step over 2% to the stencil."""
    h, w = depth.shape[-2:]
    dt = depth.dtype
    ys, xs = grid(h, w, step, depth.device)
    yy, xx = ys[:, None], xs[None, :]
    lo, hi = (normal_radius, normal_radius) if normal_radius else (0, 1)
    xl, xr = (xx - lo) % w, (xx + hi) % w
    yu, yd = (yy - lo) % h, (yy + hi) % h
    z, z_l, z_r, z_u, z_d = (
        torch.where(torch.isfinite(d), d, 0.0)
        for d in (depth[..., yy, xx], depth[..., yy, xl], depth[..., yy, xr],
                  depth[..., yu, xx], depth[..., yd, xx]))
    fx, fy, cx, cy = cam_k[0, 0], cam_k[1, 1], cam_k[0, 2], cam_k[1, 2]

    def pts(zz, col, row):
        x = (col.to(dt) - cx) * zz / fx
        y = (row.to(dt) - cy) * zz / fy
        return torch.stack(torch.broadcast_tensors(x, y, zz), dim=-1)

    c = pts(z, xx, yy)
    n = torch.linalg.cross(pts(z_d, xx, yd) - pts(z_u, xx, yu),
                           pts(z_r, xr, yy) - pts(z_l, xl, yy), dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(
        1e-20)
    ok = ((z > 0) & (z_l > 0) & (z_r > 0) & (z_u > 0) & (z_d > 0)
          & (yy >= lo) & (xx >= lo) & (yy < h - hi) & (xx < w - hi))
    n = torch.where(ok[..., None], n, 0.0)
    edge = torch.zeros_like(ok)
    for q in (z_l, z_r, z_u, z_d):
        edge = edge | ((q - z).abs() > 0.02 * z.clamp_min(1e-6))
    lead = depth.shape[:-2]
    return (c.reshape(*lead, -1, 3), n.reshape(*lead, -1, 3),
            (ok & ~edge).reshape(*lead, -1))


def bilinear(depth: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Depth of (S, H, W) maps at continuous (x, y) (S, N), and whether
    all four corners are depth inside the image. The corner's clamp and
    index are float32 whatever ``dt`` (a bfloat16 column past 256 is not
    a whole pixel), then the fractions are taken in ``dt``."""
    s, h, w = depth.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = torch.nan_to_num(x0.float()).clamp(0, w - 2)
    y0c = torch.nan_to_num(y0.float()).clamp(0, h - 2)
    fx, fy = x - x0c.to(x.dtype), y - y0c.to(y.dtype)
    flat = depth.reshape(s, -1)
    i00 = y0c.long() * w + x0c.long()
    z00, z01, z10, z11 = (torch.gather(flat, 1, i)
                          for i in (i00, i00 + 1, i00 + w, i00 + w + 1))
    ok = inb & (z00 > 0) & (z01 > 0) & (z10 > 0) & (z11 > 0)
    z = (z00 * (1 - fx) * (1 - fy) + z01 * fx * (1 - fy)
         + z10 * (1 - fx) * fy + z11 * fx * fy)
    return z, ok


def associate(depths, cam_k, rot, trans, grid_step: int,
              max_depth_err: float, normal_radius: int):
    """(obs (S, L, 3), mask (S, L), landmarks (L, 3), normals (L, 3)) at
    the current poses; the pixel coordinates a * b + c with one rounding
    into ``dt`` (a float64 product of two ``dt`` values is exact)."""
    dt = depths.dtype
    pts, nrm, valid = grid_points_normals(depths, cam_k, grid_step,
                                          normal_radius)
    landmarks = apply(rot, trans[:, None, :], pts).reshape(-1, 3)
    normals = (nrm @ rot.transpose(-1, -2)).reshape(-1, 3)
    valid0 = valid.reshape(-1)
    r_inv, t_inv = invert(rot, trans)
    p_cam = apply(r_inv, t_inv[:, None, :], landmarks)
    z_pred = p_cam[..., 2]
    zc = z_pred.clamp_min(1e-6)

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).to(dt)
    u = fma(p_cam[..., 0] / zc, cam_k[0, 0], cam_k[0, 2])
    v = fma(p_cam[..., 1] / zc, cam_k[1, 1], cam_k[1, 2])
    z_meas, ok = bilinear(depths, u, v)
    ok = (ok & valid0 & (z_pred > 0)
          & ((z_meas - z_pred).abs() < max_depth_err))
    obs = torch.where(ok[..., None], p_cam * (z_meas / zc)[..., None], 0.0)
    s = depths.shape[0]
    scans = torch.arange(s, device=depths.device)
    owner = scans.repeat_interleave(landmarks.shape[0] // s)
    mask = ok & (owner[None, :] != scans[:, None])
    return obs, mask.to(dt), landmarks, normals


# --- point-to-plane Gauss-Newton --------------------------------------

def gn_step(rot, trans, landmarks, normals, obs, mask, damping: float):
    """One step over the poses; returns (rot, trans, info)."""
    pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    centre = ((pred * mask[..., None]).sum(dim=1)
              / mask.sum(dim=1).clamp_min(1.0)[:, None])
    ry = torch.einsum("sij,slj->sli", rot, obs)
    pred = ry + trans[:, None, :]
    e = torch.einsum("lk,slk->sl", normals, pred - landmarks[None]) * mask
    delta = 3.0 * (e.abs().sum() / mask.sum().clamp_min(1.0)) + 1e-6
    w_rob = torch.sqrt(torch.clamp_max(delta / (e.abs() + 1e-12), 1.0))
    e = e * w_rob
    n_b = normals[None].expand(ry.shape)
    j = torch.cat([n_b, -torch.linalg.cross(n_b, pred - centre[:, None, :],
                                            dim=-1)], dim=-1)
    j = j * (mask * w_rob)[..., None]
    h = torch.einsum("sli,slj->sij", j, j)
    b = -torch.einsum("sli,sl->si", j, e)
    eye6 = torch.eye(6, dtype=h.dtype, device=h.device)
    h = h + (damping * torch.diag_embed(torch.einsum("sii->si", h))
             + 1e-9 * eye6)
    step, info = _solve(h, b[..., None])
    step = step[..., 0]
    step[0] = 0.0
    d_rot, d_t = exp_so3(step[..., 3:]), step[..., :3]
    new_trans = (torch.einsum("sij,sj->si", d_rot, trans - centre)
                 + centre + d_t)
    return d_rot @ rot, new_trans, info.sum()


def anchor_gauge(rot, trans, obs, mask, landmarks, normals, g: int):
    """One rigid transform of views 1.. from their observations of view
    0's ``g`` landmarks, 3 steps; returns (rot, trans, info)."""
    s = rot.shape[0]
    dev, dt = rot.device, rot.dtype
    pred = torch.einsum("sij,slj->sli", rot, obs[:, :g]) + trans[:, None, :]
    m = mask[:, :g] * (torch.arange(s, device=dev) > 0).to(dt)[:, None]
    x = landmarks[None, :g]
    n = normals[None, :g].expand(pred.shape)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    r_acc = torch.eye(3, dtype=dt, device=dev)
    t_acc = torch.zeros(3, dtype=dt, device=dev)
    info = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(3):
        p = torch.einsum("ij,slj->sli", r_acc, pred) + t_acc
        res = torch.sum(n * (p - x), dim=-1)
        j = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)
        jm = j * m[..., None]
        h = torch.einsum("sli,slj->ij", jm, j)
        b = -torch.einsum("sli,sl->i", jm, res)
        h = h + 1e-6 * torch.trace(h) / 6.0 * eye6 + 1e-12 * eye6
        step, i = _solve(h, b)
        info = info + i
        dr = exp_so3(step[:3])
        r_acc, t_acc = dr @ r_acc, torch.einsum("ij,j->i", dr,
                                                t_acc) + step[3:]
    new_rot, new_trans = rot.clone(), trans.clone()
    new_rot[1:] = r_acc @ rot[1:]
    new_trans[1:] = torch.einsum("ij,sj->si", r_acc, trans[1:]) + t_acc
    return new_rot, new_trans, info


class Singular(RuntimeError):
    """A 6x6 system of the registration could not be solved."""


def _reorder(order, obs, mask, lm, nrm, n: int):
    """The first ``n`` landmarks (of obs, mask, landmarks and normals)
    in the order ``order(n)`` gives; any after them dropped."""
    p = order(n).to(lm.device)
    return obs[:, p], mask[:, p], lm[p], nrm[p]


def register(depths: torch.Tensor, cam_k, rot0, trans0, settings: dict,
             dt=torch.float32, tf32: bool = False,
             order: Optional[Callable[[int], torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """world_from_view poses (rot (S, 3, 3), trans (S, 3)) in ``dt`` on the
    device of ``depths`` (S, H, W), from the initial poses, with the
    configuration's ``fusion`` settings (``rounds``, ``gn_iters``,
    ``grid_step``, ``normal_radius``, ``max_depth_err``,
    ``anchor_gauge``). Raises
    :class:`Singular` if a system was singular.

    ``order``, given, maps a landmark count n to a permutation of
    ``range(n)`` (an index tensor): each Gauss-Newton step, and the
    anchor gauge over view 0's landmarks, then sums its terms in that
    order. The same float32 operations summed in another order: two
    such registrations part by float32's own sum-order spread."""
    dev = depths.device

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dt)
        return torch.tensor(np.asarray(a, np.float64), dtype=dt, device=dev)
    depths, cam_k, rot, trans = map(t, (depths, cam_k, rot0, trans0))
    step, err = int(settings["grid_step"]), float(settings["max_depth_err"])
    ns = int(settings["normal_radius"])
    info = torch.zeros((), dtype=torch.int64, device=dev)
    with _matmul(tf32):
        for _ in range(int(settings["rounds"])):
            obs, mask, lm, nrm = associate(depths, cam_k, rot, trans, step,
                                           err, ns)
            for _ in range(int(settings["gn_iters"])):
                o, m, x, n = (obs, mask, lm, nrm) if order is None else \
                    _reorder(order, obs, mask, lm, nrm, lm.shape[0])
                rot, trans, i = gn_step(rot, trans, x, n, o, m, 1e-3)
                info = info + i
        if settings["anchor_gauge"]:
            h, w = depths.shape[1:]
            g = (h // step) * (w // step)
            obs, mask, lm, nrm = associate(depths, cam_k, rot, trans, step,
                                           err, ns)
            if order is not None:
                obs, mask, lm, nrm = _reorder(order, obs, mask, lm, nrm, g)
            rot, trans, i = anchor_gauge(rot, trans, obs, mask, lm, nrm, g)
            info = info + i
    if int(info) != 0:
        raise Singular(f"the reference registration met a singular "
                       f"system (summed info {int(info)})")
    return rot, trans


def ate_rmse(rot, trans, rot_gt, trans_gt) -> float:
    """Absolute trajectory error in float64: every translation expressed
    relative to view 0 in both sets, then their root mean square gap
    (``fusion.ate_rmse``'s form)."""
    def rel(r, t):
        r, t = _f64(r), _f64(t)
        return (t - t[0]) @ r[0]
    d = rel(rot, trans) - rel(rot_gt, trans_gt)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def pose_gap(rot, trans, rot_ref, trans_ref) -> float:
    """The largest gap of a rotation entry or a translation component."""
    return float(max(np.abs(_f64(rot) - _f64(rot_ref)).max(),
                     np.abs(_f64(trans) - _f64(trans_ref)).max()))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64)
    return np.asarray(a, np.float64)
