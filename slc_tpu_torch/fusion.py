"""Multi-scan fusion: Schur-complement bundle adjustment (PyTorch port of
slc_tpu/fusion.py; BASELINE config 5, no reference equivalent: the
reference is strictly single-scan).

Model: S scans with unknown world-from-scan poses (R_s, t_s) observe a
set of L shared landmarks; observation y_{s,l} is the landmark in scan
s's local frame (in practice: a point back-projected from the scan's
depth map). Gauss-Newton on

    min sum_{s,l} m_{s,l} || R_s y_{s,l} + t_s - X_l ||^2

over poses AND landmark positions X. Each GN step eliminates the
landmarks through the Schur complement:

    S_cc = H_cc - H_cl H_ll^{-1} H_lc      (6S x 6S, dense, tiny)
    delta_c = solve(S_cc, b_c - H_cl H_ll^{-1} b_l)
    delta_l = H_ll^{-1} (b_l - H_lc delta_c)

Gauge freedom is fixed by freezing scan 0's pose. Everything is float32
at full matmul precision (:func:`full_f32`); the work is small dense
einsums and solves, plain PyTorch on whichever device holds the inputs,
but for the point-to-plane step on the card, which is the hand-written
kernels of :mod:`slc_tpu_torch.kernels.p2l` (:func:`_gn_step_p2l`).
The solves use the ``_ex`` forms, which do not synchronise with the host:
the loops add up their ``info`` codes and check them once at the end
(:func:`check_info`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from slc_tpu_torch import metrics, se3
from slc_tpu_torch.calib import resolve_device
from slc_tpu_torch.kernels import p2l as kp2l


def synthetic_problem(rng, s: int = 6, l: int = 64, noise: float = 0.0,
                      drop: float = 0.2, device="cuda"):
    """Synthetic BA problem shared by tests and bench: ground-truth poses
    on a small arc + landmarks in a box; observations in scan-local
    frames, y = R^T (X - t). Draws from ``rng`` in slc_tpu's order, so
    one seed gives both packages the same problem. Returns float32
    tensors on ``device``: (obs (S,L,3), mask (S,L), rot_gt (S,3,3),
    trans_gt (S,3))."""
    dev = resolve_device(device)
    angles = np.linspace(0, 0.4, s)
    rot_gt = np.stack([se3.exp_so3(torch.tensor(
        [0.0, a, 0.05 * a], dtype=torch.float32)).numpy() for a in angles])
    trans_gt = np.stack([np.array([3.0 * a, 0.2 * a, 0.1 * a])
                         for a in angles]).astype(np.float32)
    landmarks = rng.uniform(-5, 5, size=(l, 3)).astype(np.float32)
    landmarks[:, 2] += 20.0

    obs = np.stack([
        (landmarks - trans_gt[i]) @ rot_gt[i]      # R^T (X - t)
        for i in range(s)])
    if noise:
        obs = obs + rng.normal(0, noise, obs.shape)
    mask = (rng.uniform(size=(s, l)) > drop).astype(np.float32)
    mask[0] = 1.0                                  # anchor scan sees all

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return f32(obs), f32(mask), f32(rot_gt), f32(trans_gt)


@contextlib.contextmanager
def full_f32():
    """Full float32 matmuls inside the block, whatever the caller set
    globally: TF32 off (``torch.set_float32_matmul_precision("highest")``
    and ``torch.backends.cuda.matmul.allow_tf32 = False``), both restored
    on exit. The Schur system is ill-conditioned enough that reduced
    precision moves the poses visibly (slc_tpu/fusion.py:66-76 pins
    "highest" for the same reason), and the tensors are tiny."""
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def highest_precision(fn):
    """Run ``fn`` under :func:`full_f32`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)
    return wrapped


def check_info(info: torch.Tensor, what: str) -> None:
    """Raise if any factorization summed into ``info`` failed (one read
    back to the host)."""
    if int(info) != 0:
        raise RuntimeError(f"{what}: a linear system was singular "
                           f"(summed LAPACK info {int(info)})")


def residuals(rot: torch.Tensor, trans: torch.Tensor,
              landmarks: torch.Tensor, obs: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """(S,3,3), (S,3), (L,3), (S,L,3), (S,L) -> masked (S,L,3)."""
    pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    return (pred - landmarks[None]) * mask[..., None]


def _gn_terms(rot, trans, landmarks, obs, mask):
    """Per-landmark GN blocks. Jacobians: d r / d xi_s = [I | -[R y]x],
    d r / d X_l = -I. Returns (h_cc (S,6,6), b_c (S,6),
    h_ll (L,3,3), b_l (L,3), h_cl (S,L,6,3), r)."""
    s, l = mask.shape
    ry = torch.einsum("sij,slj->sli", rot, obs)              # (S,L,3)
    r = (ry + trans[:, None, :] - landmarks[None]) * mask[..., None]

    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    jp = torch.cat([eye3.expand(s, l, 3, 3), -se3.hat(ry)],
                   dim=-1)                                   # (S,L,3,6)
    jp = jp * mask[..., None, None]

    h_cc = torch.einsum("slki,slkj->sij", jp, jp)            # (S,6,6)
    b_c = -torch.einsum("slki,slk->si", jp, r)               # (S,6)
    # J_l = -I (masked): H_ll = (#obs) I, H_cl = -J_p^T.
    nobs = mask.sum(dim=0)                                   # (L,)
    h_ll = nobs[:, None, None] * eye3[None]
    b_l = r.sum(dim=0)                                       # -J_l^T r
    h_cl = -jp.transpose(-1, -2)                             # (S,L,6,3)
    return h_cc, b_c, h_ll, b_l, h_cl, r


def _schur_reduce(h_cc, b_c, h_ll, b_l, h_cl, damping):
    """Form the reduced camera system. Returns (s_off (S,6,S,6), rhs
    (S,6), h_ll_inv, info). ``damping`` is RELATIVE (Levenberg-Marquardt
    style, lambda * diag): pose blocks mix |p|^2-scaled rotation terms
    with O(#obs) translation terms, so absolute damping cannot regularize
    the near-null directions without crushing the well-conditioned
    ones."""
    d_ll = torch.einsum("lii->l", h_ll)[:, None, None] / 3.0
    eye3 = torch.eye(3, dtype=h_ll.dtype, device=h_ll.device)
    h_ll_inv, info = torch.linalg.inv_ex(
        h_ll + (damping * d_ll + 1e-12) * eye3)
    # W_l = H_cl H_ll^{-1}: (S,L,6,3)
    w = torch.einsum("slij,ljk->slik", h_cl, h_ll_inv)
    # Off-diagonal coupling: sum_l W_s H_lc_s' = (S,6,S',6)
    s_off = torch.einsum("slik,tljk->sitj", w, h_cl)
    rhs_red = b_c - torch.einsum("slik,lk->si", w, b_l)
    return s_off, rhs_red, h_ll_inv, info.sum()


def _gn_step(rot, trans, landmarks, obs, mask, damping, reduce_fn=None):
    """One Gauss-Newton step; returns (rot, trans, landmarks, info).
    ``reduce_fn`` sums the Schur terms over landmark shards (an
    all-reduce in ``parallel.fusion_tiled``; none on one device), the
    landmark solves' ``info`` with them, so that every shard sees the
    same total and :func:`check_info` raises on all of them or none."""
    s = rot.shape[0]
    h_cc, b_c, h_ll, b_l, h_cl, _ = _gn_terms(rot, trans, landmarks, obs,
                                              mask)
    s_off, rhs_red, h_ll_inv, info = _schur_reduce(h_cc, b_c, h_ll, b_l,
                                                   h_cl, damping)
    if reduce_fn is not None:
        h_cc, s_off, rhs_red, info = (reduce_fn(h_cc), reduce_fn(s_off),
                                      reduce_fn(rhs_red), reduce_fn(info))

    diag_cc = torch.einsum("sii->si", h_cc)
    eye6 = torch.eye(6, dtype=h_cc.dtype, device=h_cc.device)
    lm_term = damping * torch.diag_embed(diag_cc) + 1e-12 * eye6
    a = (torch.block_diag(*(h_cc + lm_term)).reshape(s, 6, s, 6)
         - s_off).reshape(6 * s, 6 * s)
    # Gauge fix: freeze scan 0 (identity rows/cols, zero rhs).
    a[:6, :] = 0.0
    a[:, :6] = 0.0
    a[:6, :6] = eye6
    rhs = rhs_red.reshape(-1).clone()
    rhs[:6] = 0.0

    delta_c, info_c = torch.linalg.solve_ex(a, rhs)
    delta_c = delta_c.reshape(s, 6)

    # Landmark back-substitution: b_l - H_lc delta_c, H_lc = H_cl^T.
    corr = b_l - torch.einsum("slij,si->lj", h_cl, delta_c)
    delta_l = torch.einsum("lij,lj->li", h_ll_inv, corr)

    # Update parameterization matching the Jacobian [I | -[Ry]x]:
    # R' = exp(w) R, t' = t + dt (translation NOT rotated).
    d_rot, d_t = se3.exp_se3(delta_c)
    return d_rot @ rot, trans + d_t, landmarks + delta_l, info + info_c


@highest_precision
def gn_step(rot, trans, landmarks, obs, mask, damping: float = 1e-3,
            reduce_fn=None):
    """One Gauss-Newton step of the point-to-point bundle adjustment
    (``reduce_fn`` as in slc_tpu/fusion.py:131-144: it sums the Schur
    terms across landmark shards). Returns (rot, trans, landmarks)."""
    *out, info = _gn_step(rot, trans, landmarks, obs, mask, damping,
                          reduce_fn)
    check_info(info, "gn_step")
    return tuple(out)


def _gn_terms_p2l(rot, trans, landmarks, normals, obs, mask, center):
    """Point-to-plane GN blocks: scalar residual e = n_l . (R_s y + t_s
    - X_l) with the landmark's world normal n_l and rotation levers
    centered on ``center`` (S, 3). J_pose = [n | -(n x (pred - c))]
    (1x6). Point-to-plane kills the tangential-sliding null directions
    of point-to-point projective association; centroid-centered rotation
    keeps the pose Hessian conditioned at f32."""
    ry = torch.einsum("sij,slj->sli", rot, obs)              # (S,L,3)
    pred = ry + trans[:, None, :]
    e = torch.einsum("lk,slk->sl", normals,
                     pred - landmarks[None]) * mask          # (S,L)

    # Huber reweighting (delta = 3x the masked-mean |e|): occlusion
    # boundaries and normal flips produce heavy-tailed residuals that
    # plain least squares lets dominate the step.
    mean_abs = e.abs().sum() / mask.sum().clamp_min(1.0)
    delta = 3.0 * mean_abs + 1e-6
    w_rob = torch.sqrt(torch.clamp_max(delta / (e.abs() + 1e-12), 1.0))
    e = e * w_rob

    lever = pred - center[:, None, :]                        # (S,L,3)
    n_b = normals[None].expand(ry.shape)                     # (S,L,3)
    j = torch.cat([n_b, -torch.linalg.cross(n_b, lever, dim=-1)],
                  dim=-1)                                    # (S,L,6)
    j = j * (mask * w_rob)[..., None]

    h_cc = torch.einsum("sli,slj->sij", j, j)                # (S,6,6)
    b_c = -torch.einsum("sli,sl->si", j, e)                  # (S,6)
    return h_cc, b_c, e


def _p2l_kernel_route(obs: torch.Tensor, reduce_fn=None) -> bool:
    """Whether the point-to-plane step runs as the hand-written kernels:
    for tensors off the CPU with no shard reduction (the kernels sum over
    every landmark of the card themselves). Where the tensors are is the
    only question: it is one algorithm."""
    return reduce_fn is None and obs.device.type != "cpu"


def _gn_step_p2l(rot, trans, landmarks, normals, obs, mask, damping,
                 reduce_fn=None):
    """One point-to-plane step; returns (rot, trans, landmarks, info).
    ``reduce_fn`` sums the centroids and the pose blocks over landmark
    shards (slc_tpu/fusion.py:206-219); the solve is then the same on
    every shard, and so is its ``info``.

    Off the CPU with no ``reduce_fn`` the step is the kernels of
    :mod:`slc_tpu_torch.kernels.p2l` (or raises; CUDA float32 tensors),
    with scratch of its own. Elsewhere the plain code below, the kernels'
    reference."""
    if _p2l_kernel_route(obs, reduce_fn):
        work = kp2l.P2LWork(*mask.shape, obs.device)
        rot, trans = kp2l.gn_step_p2l_cuda(
            rot.contiguous(), trans.contiguous(), landmarks.contiguous(),
            normals.contiguous(), obs.contiguous(), mask.contiguous(),
            damping, work)
        return rot, trans, landmarks, work.info
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    csum = red((pred * mask[..., None]).sum(dim=1))          # (S,3)
    nobs = red(mask.sum(dim=1)).clamp_min(1.0)               # (S,)
    center = csum / nobs[:, None]

    h_cc, b_c, _ = _gn_terms_p2l(rot, trans, landmarks, normals, obs,
                                 mask, center)
    h_cc, b_c = red(h_cc), red(b_c)
    diag_cc = torch.einsum("sii->si", h_cc)
    eye6 = torch.eye(6, dtype=h_cc.dtype, device=h_cc.device)
    lm_term = damping * torch.diag_embed(diag_cc) + 1e-9 * eye6
    delta_c, info = torch.linalg.solve_ex(h_cc + lm_term, b_c[..., None])
    delta_c = delta_c[..., 0]
    delta_c[0] = 0.0                                         # gauge

    # Centroid-centered update: pred' = exp(w)(pred - c) + c + dt, i.e.
    # R' = exp(w) R, t' = exp(w)(t - c) + c + dt.
    d_rot, d_t = se3.exp_se3(delta_c)
    new_trans = (torch.einsum("sij,sj->si", d_rot, trans - center)
                 + center + d_t)
    return d_rot @ rot, new_trans, landmarks, info.sum()


@highest_precision
def gn_step_p2l(rot, trans, landmarks, normals, obs, mask,
                damping: float = 1e-3, reduce_fn=None):
    """One point-to-plane Gauss-Newton step over POSES ONLY.

    Landmarks stay fixed: a free landmark under scalar point-to-plane
    residuals has 3 DoF against <= a handful of equations, so it can
    absorb every observation and leave the poses unconstrained. Classic
    ICP therefore treats the associated surface anchors as data; they
    are re-estimated only in the association round. With fixed
    landmarks the pose Hessian is block-diagonal (no Schur coupling).
    ``reduce_fn`` sums over landmark shards. On the card with no
    ``reduce_fn`` the step runs as the kernels of
    :mod:`slc_tpu_torch.kernels.p2l` (:func:`_gn_step_p2l`). Returns (rot,
    trans, landmarks)."""
    *out, info = _gn_step_p2l(rot, trans, landmarks, normals, obs, mask,
                              damping, reduce_fn)
    check_info(info, "gn_step_p2l")
    return tuple(out)


def _fuse_scans_p2l(obs, mask, normals, rot, trans, landmarks, iters,
                    damping):
    """:func:`fuse_scans_p2l`, returning (rot, trans, landmarks, info);
    each step adds 1 to the counter ``fusion.gn_steps`` and, 1 where it
    ran as the kernels and 0 where it ran plain, to
    ``fusion.p2l_kernel``. The kernels' scratch is allocated once here,
    and their steps sum their codes into it."""
    kernel = _p2l_kernel_route(obs)
    if kernel:
        work = kp2l.P2LWork(*mask.shape, obs.device)
        rot, trans, obs, mask, nrm, lm = (
            t.contiguous() for t in (rot, trans, obs, mask, normals,
                                     landmarks))
        info = work.info
    else:
        info = torch.zeros((), dtype=torch.int64, device=obs.device)
    for _ in range(iters):
        if kernel:
            rot, trans = kp2l.gn_step_p2l_cuda(rot, trans, lm, nrm, obs,
                                               mask, damping, work)
        else:
            rot, trans, landmarks, i = _gn_step_p2l(rot, trans, landmarks,
                                                    normals, obs, mask,
                                                    damping)
            info = info + i
        metrics.count("fusion.gn_steps")
        metrics.count("fusion.p2l_kernel", int(kernel))
    return rot, trans, landmarks, info


@highest_precision
def fuse_scans_p2l(obs: torch.Tensor, mask: torch.Tensor,
                   normals: torch.Tensor, init_rot: torch.Tensor,
                   init_trans: torch.Tensor, init_landmarks: torch.Tensor,
                   iters: int = 10, damping: float = 1e-3):
    """Point-to-plane multi-scan alignment (normals (L, 3) in world).
    Returns (rot (S,3,3), trans (S,3), landmarks (L,3))."""
    *out, info = _fuse_scans_p2l(obs, mask, normals, init_rot, init_trans,
                                 init_landmarks, iters, damping)
    check_info(info, "fuse_scans_p2l")
    return tuple(out)


@highest_precision
def fuse_scans(obs: torch.Tensor, mask: torch.Tensor,
               init_rot: Optional[torch.Tensor] = None,
               init_trans: Optional[torch.Tensor] = None,
               init_landmarks: Optional[torch.Tensor] = None,
               iters: int = 10, damping: float = 1e-3):
    """Bundle adjustment on the device of ``obs``.

    Args:
      obs: (S, L, 3) landmark observations in each scan's local frame.
      mask: (S, L) 1.0 where scan s observes landmark l.
    Returns (rot (S,3,3), trans (S,3), landmarks (L,3)).
    """
    s, l = mask.shape
    rot = (init_rot if init_rot is not None
           else torch.eye(3, dtype=obs.dtype, device=obs.device)
           .expand(s, 3, 3))
    trans = (init_trans if init_trans is not None
             else torch.zeros((s, 3), dtype=obs.dtype, device=obs.device))
    lm = init_landmarks
    if lm is None:
        # Initialize landmarks as the masked mean of transformed obs.
        pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
        lm = ((pred * mask[..., None]).sum(dim=0)
              / mask.sum(dim=0)[:, None].clamp_min(1.0))
    info = torch.zeros((), dtype=torch.int64, device=obs.device)
    for _ in range(iters):
        rot, trans, lm, i = _gn_step(rot, trans, lm, obs, mask, damping)
        info = info + i
    check_info(info, "fuse_scans")
    return rot, trans, lm


@highest_precision
def ate_rmse(rot, trans, rot_gt, trans_gt) -> torch.Tensor:
    """Absolute trajectory error after aligning to the gauge of scan 0:
    express every pose relative to scan 0 in both sets, compare
    translations."""
    r0i, t0i = se3.invert(rot[0], trans[0])
    g0i, g0t = se3.invert(rot_gt[0], trans_gt[0])
    rel_t = torch.einsum("ij,sj->si", r0i, trans) + t0i
    rel_gt = torch.einsum("ij,sj->si", g0i, trans_gt) + g0t
    return torch.sqrt(torch.mean(torch.sum((rel_t - rel_gt) ** 2, dim=-1)))
