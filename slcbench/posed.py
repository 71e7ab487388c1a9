"""A world scene seen from posed views: the surfaces of a multi-view sweep.

The scene of the port's ``synth.render_depth_from_pose`` (bench.py's
config-5 frontend, lines 453-521): spheres at (0, 0, 60) of radius 20 and
at (18, -10, 70) of radius 12 over the tilted plane through (0, 0, 80)
with normal (0.15, 0.1, -1), moved by a shift in x and y. View i of a
sweep of V looks at it from an orbit about (0, 0, 62), rotated by
(0.006, 0.025, 0) (i - V // 2) rad. A view's surface maps the camera's
ray directions (dx, dy, 1) to the depth along its own z axis, ray-cast in
float64 from the view's world_from_camera pose (R, t) as
``render_depth_from_pose`` casts it, so ``scenes.Renderer`` renders the
view's pattern stack as it renders any surface: the projector is rigid
with the camera and moves with it. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from slcbench.scenes import Surface

SPHERES = (((0.0, 0.0, 60.0), 20.0), ((18.0, -10.0, 70.0), 12.0))
PLANE_POINT = (0.0, 0.0, 80.0)
PLANE_NORMAL = (0.15, 0.1, -1.0)
ORBIT_CENTER = (0.0, 0.0, 62.0)
ORBIT_STEP = (0.006, 0.025, 0.0)
#: The depth given to a ray that meets nothing: beyond every rig's field
#: of view, so the decode makes it a hole.
MISS_Z = 1e4


def exp_so3(w: Sequence[float]) -> np.ndarray:
    """Rodrigues' formula in float64: axis-angle (3,) -> rotation (3, 3)."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + k
    return (np.eye(3) + np.sin(th) / th * k
            + (1.0 - np.cos(th)) / th ** 2 * (k @ k))


def orbit(views: int) -> Tuple[np.ndarray, np.ndarray]:
    """The sweep's true world_from_camera poses, float64: rotations
    (V, 3, 3) about the orbit's centre c and translations (I - R) c."""
    c = np.asarray(ORBIT_CENTER, np.float64)
    rot = np.stack([exp_so3(np.asarray(ORBIT_STEP) * (i - views // 2))
                    for i in range(views)])
    return rot, np.stack([(np.eye(3) - r) @ c for r in rot])


def perturb(rng: np.random.Generator, rot: np.ndarray, trans: np.ndarray,
            rot_sigma: float, trans_sigma: float
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Initial poses: view 0 exact (it fixes the gauge), each later view
    turned by exp(N(0, rot_sigma)) and moved by N(0, trans_sigma) a
    component, drawn from ``rng`` in view order."""
    rot0, trans0 = rot.copy(), trans.copy()
    for i in range(1, len(rot)):
        rot0[i] = exp_so3(rng.normal(0.0, rot_sigma, 3)) @ rot0[i]
        trans0[i] = trans0[i] + rng.normal(0.0, trans_sigma, 3)
    return rot0, trans0


def surface(rot: np.ndarray, trans: np.ndarray,
            shift: Sequence[float] = (0.0, 0.0)) -> Surface:
    """The scene, moved by ``shift`` in x and y, as the camera at pose
    (rot, trans) sees it: camera-frame depth per ray direction."""
    r = [[float(v) for v in row] for row in np.asarray(rot, np.float64)]
    o = np.asarray(trans, np.float64)
    sh = np.array([shift[0], shift[1], 0.0])

    def f(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        # World-frame ray directions R (dx, dy, 1); the ray parameter is
        # the camera-frame depth, as its z component is 1.
        d = [r[i][0] * dx + r[i][1] * dy + r[i][2] for i in range(3)]
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        t = torch.full_like(dx, float("inf"))
        for centre, radius in SPHERES:
            oc = o - (np.asarray(centre) + sh)
            b = 2.0 * (d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2])
            cc = float(oc @ oc) - radius ** 2
            disc = b * b - 4.0 * a * cc
            ts = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
            t = torch.minimum(t, torch.where((disc > 0) & (ts > 0), ts,
                                             float("inf")))
        n = np.asarray(PLANE_NORMAL)
        den = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        num = float((np.asarray(PLANE_POINT) + sh - o) @ n)
        tp = num / torch.where(den.abs() > 1e-12, den, torch.ones_like(den))
        t = torch.minimum(t, torch.where((den.abs() > 1e-12) & (tp > 0), tp,
                                         float("inf")))
        return torch.where(torch.isfinite(t), t, MISS_Z)
    return f
