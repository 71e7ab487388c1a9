"""Synthetic scene rendering — the framework's test fixture generator.

The reference's only validation mechanism is replaying pre-captured BMPs
through a simulated sensor (DynaFrame/CSensorV.cpp:4-6). We go further:
render analytic scenes (planes, spheres) through the exact projector-
camera model, so every pipeline stage has dense ground truth.

All rendering is host-side numpy float64; outputs are uint8 camera images
(matching the reference's 8-bit BMPs, CSensorV.cpp:111-114) plus the exact
per-pixel ground-truth depth and projector correspondence.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from slc_tpu_torch import patterns
from slc_tpu_torch.calib import Calibration, project_to_projector
from slc_tpu_torch.config import SystemConfig

# An analytic surface: (x_dir, y_dir) normalized camera-ray direction
# grids -> depth z (camera frame) per pixel.
Surface = Callable[[np.ndarray, np.ndarray], np.ndarray]


def plane_surface(z0: float = 50.0, gx: float = 0.0,
                  gy: float = 0.0) -> Surface:
    """Plane z = z0 + gx*X + gy*Y intersected along camera rays:
    z (1 - gx*dx - gy*dy) = z0 for ray (dx*z, dy*z, z)."""
    def f(dx, dy):
        return z0 / (1.0 - gx * dx - gy * dy)
    return f


def offset_surface(surface: Surface, dz: float) -> Surface:
    """The surface translated by ``dz`` along +z — how a dynamic
    sequence moves the DECODED scene (one definition shared by the
    capture loop, the synth CLI, and anchor rendering, so frame-0 /
    anchor / dynamic geometry cannot drift apart again — the round-5
    scene-consistency bug was exactly three hand-rolled copies of this
    lambda disagreeing about which surface moves)."""
    return lambda dx, dy: surface(dx, dy) + dz


def sphere_surface(center=(0.0, 0.0, 60.0), radius: float = 25.0,
                   background_z: float = 75.0) -> Surface:
    """Sphere over a background plane; rays that miss hit the plane."""
    cx, cy, cz = center

    def f(dx, dy):
        # Ray p(t) = t*(dx, dy, 1): |p - c|^2 = r^2.
        a = dx * dx + dy * dy + 1.0
        b = -2.0 * (dx * cx + dy * cy + cz)
        c = cx * cx + cy * cy + cz * cz - radius * radius
        disc = b * b - 4.0 * a * c
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
        return np.where(hit & (t > 0), t, background_z)
    return f


@dataclasses.dataclass
class RenderedScene:
    """Ground truth + rendered camera image stacks for one static scene."""
    z_gt: np.ndarray           # (H, W) float64 ground-truth depth
    proj_u: np.ndarray         # (H, W) float64 continuous projector column
    gray_images: np.ndarray    # (2*bits, H, W) uint8
    phase_images: np.ndarray   # (N, H, W) uint8


def camera_ray_dirs(calib: Calibration, cam_h: int, cam_w: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    k = np.asarray(calib.cam_k, np.float64)
    u = (np.arange(cam_w, dtype=np.float64)[None, :] - k[0, 2]) / k[0, 0]
    v = (np.arange(cam_h, dtype=np.float64)[:, None] - k[1, 2]) / k[1, 1]
    return np.broadcast_to(u, (cam_h, cam_w)), np.broadcast_to(v, (cam_h, cam_w))


def surface_geometry(calib: Calibration, cfg: SystemConfig,
                     surface: Surface) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect camera rays with the surface; return (z_gt, proj_u)."""
    dx, dy = camera_ray_dirs(calib, cfg.cam_h, cfg.cam_w)
    z = surface(dx, dy)
    xyz = np.stack([dx * z, dy * z, z], axis=-1)
    pu, _ = project_to_projector(calib, xyz)
    return z, pu


def _quantize(img: np.ndarray, noise_sigma: float,
              rng: Optional[np.random.Generator]) -> np.ndarray:
    if noise_sigma > 0:
        assert rng is not None
        img = img + rng.normal(0.0, noise_sigma, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def render_static_scene(calib: Calibration, cfg: SystemConfig,
                        surface: Surface, noise_sigma: float = 0.0,
                        seed: int = 0) -> RenderedScene:
    """Render the frame-0 pattern budget: 2*bits Gray images + N fringe
    images (CSensorV.cpp:72,80), sampling each pattern at the exact
    continuous projector correspondence of every camera pixel."""
    rng = np.random.default_rng(seed) if noise_sigma > 0 else None
    z, pu = surface_geometry(calib, cfg, surface)
    gp = cfg.gray_period

    gray = np.empty((2 * cfg.gray_bits, cfg.cam_h, cfg.cam_w), np.uint8)
    for k in range(cfg.gray_bits):
        bit = patterns.gray_bit_at(pu, k, gp).astype(np.float64) * 255.0
        gray[2 * k] = _quantize(bit, noise_sigma, rng)
        gray[2 * k + 1] = _quantize(255.0 - bit, noise_sigma, rng)

    phase = np.empty((cfg.phase_steps, cfg.cam_h, cfg.cam_w), np.uint8)
    for k in range(cfg.phase_steps):
        phase[k] = _quantize(
            patterns.fringe_at(pu, k, cfg.phase_steps, cfg.phase_period),
            noise_sigma, rng)

    return RenderedScene(z_gt=z, proj_u=pu, gray_images=gray,
                         phase_images=phase)


def render_fringe_stack(calib: Calibration, cfg: SystemConfig,
                        surface: Surface, periods, steps: int,
                        noise_sigma: float = 0.0, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a multi-frequency fringe stack (len(periods)*steps images)
    for heterodyne unwrapping (BASELINE config 2). Returns
    (images (F*N, H, W) uint8, z_gt, proj_u)."""
    rng = np.random.default_rng(seed) if noise_sigma > 0 else None
    z, pu = surface_geometry(calib, cfg, surface)
    imgs = np.empty((len(periods) * steps, cfg.cam_h, cfg.cam_w), np.uint8)
    i = 0
    for t in periods:
        for k in range(steps):
            imgs[i] = _quantize(patterns.fringe_at(pu, k, steps, t),
                                noise_sigma, rng)
            i += 1
    return imgs, z, pu


def render_depth_from_pose(calib: Calibration, cam_h: int, cam_w: int,
                           rot: np.ndarray, trans: np.ndarray,
                           spheres=(((0.0, 0.0, 60.0), 20.0),
                                    ((18.0, -10.0, 70.0), 12.0)),
                           plane_point=(0.0, 0.0, 80.0),
                           plane_normal=(0.15, 0.1, -1.0)) -> np.ndarray:
    """Ray-cast a world-frame scene (spheres over a tilted background
    plane) from camera pose (rot, trans) = world_from_camera. Returns
    the (H, W) float64 depth map IN THE CAMERA FRAME (z along the
    camera axis), 0 where no hit. The default scene has spheres of two
    sizes and a tilted plane so surface normals span enough directions
    for 6-DoF registration to be well-posed (a single frontal plane
    leaves lateral translation unobservable under point-to-plane).
    Used by the multi-scan fusion tests/benchmarks (no reference
    equivalent)."""
    k = np.asarray(calib.cam_k, np.float64)
    u = (np.arange(cam_w, dtype=np.float64)[None, :] - k[0, 2]) / k[0, 0]
    v = (np.arange(cam_h, dtype=np.float64)[:, None] - k[1, 2]) / k[1, 1]
    d_cam = np.stack([np.broadcast_to(u, (cam_h, cam_w)),
                      np.broadcast_to(v, (cam_h, cam_w)),
                      np.ones((cam_h, cam_w))], axis=-1)
    rot = np.asarray(rot, np.float64)
    trans = np.asarray(trans, np.float64)
    d_w = d_cam @ rot.T                       # world-frame ray direction
    o = trans                                 # ray origin (camera center)

    t = np.full((cam_h, cam_w), np.inf)
    a = np.sum(d_w * d_w, axis=-1)
    for center, radius in spheres:
        # |o + t d - c|^2 = r^2 (t in camera-frame depth units since
        # d_cam_z = 1).
        oc = o - np.asarray(center, np.float64)
        b = 2.0 * np.sum(d_w * oc, axis=-1)
        cc = np.dot(oc, oc) - radius ** 2
        disc = b * b - 4.0 * a * cc
        t_s = np.where(disc > 0,
                       (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a),
                       np.inf)
        t = np.minimum(t, np.where(t_s > 0, t_s, np.inf))

    n = np.asarray(plane_normal, np.float64)
    p0 = np.asarray(plane_point, np.float64)
    denom = d_w @ n
    t_pl = np.where(np.abs(denom) > 1e-12, ((p0 - o) @ n) / denom, np.inf)
    t = np.minimum(t, np.where(t_pl > 0, t_pl, np.inf))
    return np.where(np.isfinite(t), t, 0.0)


def step_surface(z_left: float, z_right: float,
                 dx_edge: float = 0.0) -> Surface:
    """Two fronto-parallel planes split by a vertical depth step at
    camera-ray direction ``dx_edge`` — the discontinuous scene used to
    validate phase-locked tracking across fringe-order jumps."""
    def f(dx, dy):
        return np.where(dx < dx_edge, z_left, z_right)
    return f


def render_dynamic_sequence(calib: Calibration, cfg: SystemConfig,
                            num_frames: int,
                            z0: float = 50.0, dz_per_frame: float = 0.08,
                            stripe_period: int = 40,
                            noise_sigma: float = 0.0, seed: int = 0,
                            surface_for_frame: Optional[
                                Callable[[int], Surface]] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render a moving-plane sequence lit by the single stripe pattern —
    the cFrame scenario (CSensorV.cpp:88-92): one image per frame of a
    plane translating along +z. ``surface_for_frame`` overrides the
    default plane with an arbitrary per-frame surface (e.g. a moving
    :func:`step_surface` for discontinuity tests).

    Returns (frames (F, H, W) uint8, z_gt (F, H, W), proj_u (F, H, W)).
    """
    frames = np.empty((num_frames, cfg.cam_h, cfg.cam_w), np.uint8)
    z_gt = np.empty((num_frames, cfg.cam_h, cfg.cam_w))
    pu_gt = np.empty_like(z_gt)
    for f, (frame, z, pu) in enumerate(iter_dynamic_sequence(
            calib, cfg, num_frames, z0, dz_per_frame, stripe_period,
            noise_sigma, seed, surface_for_frame)):
        frames[f], z_gt[f], pu_gt[f] = frame, z, pu
    return frames, z_gt, pu_gt


def iter_dynamic_sequence(calib: Calibration, cfg: SystemConfig,
                          num_frames: int,
                          z0: float = 50.0, dz_per_frame: float = 0.08,
                          stripe_period: int = 40,
                          noise_sigma: float = 0.0, seed: int = 0,
                          surface_for_frame: Optional[
                              Callable[[int], Surface]] = None
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]]:
    """:func:`render_dynamic_sequence` one frame at a time: yields each
    frame's (frame uint8, z_gt, proj_u), the same values, so a long
    sequence at full size need not be held."""
    rng = np.random.default_rng(seed) if noise_sigma > 0 else None
    for f in range(num_frames):
        surf = (plane_surface(z0 + dz_per_frame * f)
                if surface_for_frame is None else surface_for_frame(f))
        z, pu = surface_geometry(calib, cfg, surf)
        yield (_quantize(patterns.stripe_at(pu, stripe_period), noise_sigma,
                         rng), z, pu)
