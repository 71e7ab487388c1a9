"""Scene generator: camera images of analytic surfaces, rendered on the
device from the seed, then handed to the host as a camera would hand
them.

A copy of the port's synthetic rig and renderer (``slc_tpu_torch/calib.
synthetic_calibration``, ``synth.py``, ``patterns.py``) in float64
torch: surfaces intersected along camera rays, projected into the
projector, each pattern sampled at the continuous projector column, u8
quantisation after Gaussian noise drawn from a ``torch.Generator`` in one
call per stack. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch

Surface = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def synthetic_calibration(cam_h: int, cam_w: int, pro_h: int, pro_w: int,
                          baseline: float = 20.0, z_work: float = 50.0,
                          cam_f: float = 600.0, pro_f: float = 400.0
                          ) -> Dict[str, np.ndarray]:
    """The port's synthetic rig: the projector displaced ``baseline``
    along +x and toed in so both axes meet at ``z_work``. Values rounded
    to float32, as the port's Calibration stores them."""
    cam_k = np.array([[cam_f, 0.0, (cam_w - 1) / 2.0],
                      [0.0, cam_f, (cam_h - 1) / 2.0], [0.0, 0.0, 1.0]])
    pro_k = np.array([[pro_f, 0.0, (pro_w - 1) / 2.0],
                      [0.0, pro_f, (pro_h - 1) / 2.0], [0.0, 0.0, 1.0]])
    th = -np.arctan2(baseline, z_work)
    rot = np.array([[np.cos(th), 0.0, -np.sin(th)], [0.0, 1.0, 0.0],
                    [np.sin(th), 0.0, np.cos(th)]])
    trans = -rot @ np.array([baseline, 0.0, 0.0])
    return {k: np.asarray(v, np.float32) for k, v in
            (("cam_k", cam_k), ("pro_k", pro_k), ("rot", rot),
             ("trans", trans.reshape(3)))}


def plane(z0: float, gx: float = 0.0, gy: float = 0.0) -> Surface:
    """z = z0 + gx X + gy Y along camera rays."""
    return lambda dx, dy: z0 / (1.0 - gx * dx - gy * dy)


def offset(surface: Surface, dz: float) -> Surface:
    """The surface moved ``dz`` along +z."""
    return lambda dx, dy: surface(dx, dy) + dz


def sphere(center: Sequence[float], radius: float,
           background_z: float) -> Surface:
    """A sphere over a background plane; rays that miss hit the plane."""
    cx, cy, cz = center

    def f(dx, dy):
        a = dx * dx + dy * dy + 1.0
        b = -2.0 * (dx * cx + dy * cy + cz)
        c = cx * cx + cy * cy + cz * cz - radius * radius
        disc = b * b - 4.0 * a * c
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
        return torch.where((disc > 0) & (t > 0), t,
                           torch.full_like(t, background_z))
    return f


class Renderer:
    """Renders stacks for one rig on ``device``; noise from ``gen``."""

    def __init__(self, cal: Dict[str, np.ndarray], sysc: dict, device,
                 gen: torch.Generator, noise_sigma: float):
        self.sysc = sysc
        self.device = device
        self.gen = gen
        self.sigma = float(noise_sigma)
        h, w = sysc["cam_h"], sysc["cam_w"]
        k = np.asarray(cal["cam_k"], np.float64)
        f64 = dict(dtype=torch.float64, device=device)
        u = (torch.arange(w, **f64)[None, :] - float(k[0, 2])) / float(k[0, 0])
        v = (torch.arange(h, **f64)[:, None] - float(k[1, 2])) / float(k[1, 1])
        self.dx, self.dy = u.expand(h, w), v.expand(h, w)
        rt = np.concatenate([np.asarray(cal["rot"], np.float64),
                             np.asarray(cal["trans"], np.float64)
                             .reshape(3, 1)], axis=1)
        self.p = torch.tensor(np.asarray(cal["pro_k"], np.float64) @ rt,
                              **f64)

    def geometry(self, surface: Surface):
        """(z, projector column) per camera pixel, float64."""
        z = surface(self.dx, self.dy)
        xyz = torch.stack([self.dx * z, self.dy * z, z], -1)
        hom = xyz @ self.p[:, :3].T + self.p[:, 3]
        return z, hom[..., 0] / hom[..., 2]

    def quantize(self, imgs: torch.Tensor) -> torch.Tensor:
        """Noise, round half to even, clip to u8: one draw for the stack."""
        if self.sigma > 0:
            imgs = imgs + self.sigma * torch.randn(
                imgs.shape, generator=self.gen, dtype=torch.float64,
                device=self.device)
        return torch.clamp(torch.round(imgs), 0, 255).to(torch.uint8)

    def gray_phase(self, surface: Surface) -> torch.Tensor:
        """The frame-0 pattern budget: 2B Gray images (pattern, inverse)
        and N phase images (CSensorV.cpp:72,80), (2B+N, H, W) u8."""
        s = self.sysc
        _, pu = self.geometry(surface)
        gp = s["pro_w"] / (1 << s["gray_bits"])
        tp = s["pro_w"] // (1 << (s["gray_bits"] - 1))
        b = torch.floor(pu / gp).to(torch.int64)
        g = b ^ (b >> 1)
        imgs = []
        for k in range(s["gray_bits"]):
            bit = ((g >> k) & 1).to(torch.float64) * 255.0
            imgs += [bit, 255.0 - bit]
        n = s["phase_steps"]
        imgs += [fringe_at(pu, k, n, tp) for k in range(n)]
        return self.quantize(torch.stack(imgs))

    def fringes(self, surface: Surface, counts: Sequence[int],
                steps: int) -> torch.Tensor:
        """A multi-frequency fringe stack, finest first, (F*N, H, W) u8."""
        _, pu = self.geometry(surface)
        pw = self.sysc["pro_w"]
        return self.quantize(torch.stack(
            [fringe_at(pu, k, steps, pw / c) for c in counts
             for k in range(steps)]))

    def stripes(self, surfaces: Sequence[Surface],
                period: float) -> torch.Tensor:
        """One stripe image per surface (the cFrame scenario,
        CSensorV.cpp:88-92), (F, H, W) u8."""
        return self.quantize(torch.stack(
            [stripe_at(self.geometry(s)[1], period) for s in surfaces]))


def fringe_at(x: torch.Tensor, step: int, n: int,
              period: float) -> torch.Tensor:
    """(sin(2 pi (x - 0.5) / T + 2 pi k / N) + 1) 127 (CDecodePhase.cpp:
    59-62)."""
    phi = 2.0 * math.pi * (x - 0.5) / period
    return (torch.sin(phi + step * 2.0 * math.pi / n) + 1.0) * 127.0


def stripe_at(x: torch.Tensor, period: float) -> torch.Tensor:
    """(cos(2 pi x / T) + 1) 127: the tracked stripe pattern."""
    return (torch.cos(2.0 * math.pi * x / period) + 1.0) * 127.0


def calibration(config: dict) -> Dict[str, np.ndarray]:
    """The configuration's rig at its camera and projector sizes."""
    s = config["system"]
    return synthetic_calibration(s["cam_h"], s["cam_w"], s["pro_h"],
                                 s["pro_w"], **config["calibration"])


def renderer(config: dict, cal: Dict[str, np.ndarray], device, seed: int,
             noise_sigma: float) -> Renderer:
    """A renderer whose noise is drawn from the seed on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    return Renderer(cal, config["system"], device, gen, noise_sigma)


def pattern_stack(ren: Renderer, config: dict,
                  surface: Surface) -> list:
    """The configuration's frame-0 pattern stack on the host, in the parts
    the program takes: [Gray images, phase images] or [fringe stack]."""
    if config["decode"] == "grayphase":
        imgs = ren.gray_phase(surface).cpu().numpy()
        b = 2 * config["system"]["gray_bits"]
        return [np.ascontiguousarray(imgs[:b]),
                np.ascontiguousarray(imgs[b:])]
    h = config["heterodyne"]
    return [ren.fringes(surface, h["fringe_counts"],
                        h["phase_steps"]).cpu().numpy()]
