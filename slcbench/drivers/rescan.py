"""Spatial re-scans, closed loop: per sequence one absolute Gray + phase
decode of frame 0, then every later map from its phase images alone,
unwrapped spatially and anchored on the map before it, each map fetched
to the host before the next frame is handed over.

Per sequence, as ``run_replay``'s spatial re-anchor decodes an anchor
group: the frame-0 pattern stack to the device (a pageable copy, as
``to_dev``), ``pipeline.decode_first_frame``, z to the host; then per
frame its N phase images to the device, ``pipeline.decode_spatial_frame``
with ``anchor`` the previous map's P and the configuration's ``spatial``
settings, and ``streaming.fetch_z_async``, waited on. A map's latency
runs from the start of its images' copy to its z on the host.

Traffic parameters (``traffic/<mix>.json``): ``sequences`` distinct
sequences played in turn, ``frames`` per sequence, alternately a
``sphere`` (centre ``center_xy``/``center_z``, ``radius``, background
``background_z``) over a background plane and a ``plane`` (``z0``,
``tilt``), the sphere first, each moving ``dz_per_frame`` along z a
frame, every value drawn uniformly from its [low, high] range by the
seed; ``noise_sigma``; ``checked_frames``
spatial frames drawn by the seed and compared, with frame 0, in the
first sequence the window plays, besides the last map it completes;
``warmup_frames`` per sequence in set-up.

The check decodes each compared spatial frame with the plain reference
(``reference/spatial.py``) from the same images and the same anchor,
the program's own map of the frame before, so like is compared with
like; and holds the map's fringe order against the renderer's projector
map, so a slip of a whole period anywhere in the chain of anchors shows.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import slc_tpu_torch.calib as pcalib
import slc_tpu_torch.config as pconfig
import slc_tpu_torch.ops.filters as pfilters
import slc_tpu_torch.ops.unwrap_spatial as punwrap
import slc_tpu_torch.pipeline as ppipeline
from slcbench import compare, program, scenes
from slcbench.harness import Cell, Tally, Window
from slcbench.reference import plain, spatial

#: Frames rendered between two waits on the device.
RENDER_CHUNK = 20


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


class Program:
    """The system under test for a spatial configuration: the tables on
    the device, built once, and the port's public functions, each looked
    up on its module at call time so that a test can put a broken one in
    its place."""

    def __init__(self, config: dict, cal: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        s = config["system"]
        self.cfg = pconfig.SystemConfig(**s)
        if config["decode"] != "spatial" or config["frame0"] != "grayphase":
            raise ValueError(f"not a spatial configuration: decode "
                             f"{config['decode']!r}, frame0 "
                             f"{config.get('frame0')!r}")
        self.sp = sp = config["spatial"]
        if float(sp["period"]) != float(self.cfg.phase_period):
            raise ValueError(f"spatial period {sp['period']} is not the "
                             f"rig's phase period {self.cfg.phase_period}")
        # decode_spatial_frame takes neither the solver's tol nor the
        # filter's settings: the port runs its defaults, which the
        # reference reads from the configuration.
        f = sp["bilateral"]
        want = {"tol": sp["tol"], "radius": f["radius"],
                "sigma_color": f["sigma_color"],
                "sigma_space": f["sigma_space"], "hole_aware": True}
        got = {**_defaults(punwrap.unwrap_spatial),
               **_defaults(pfilters.bilateral_filter)}
        bad = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        if bad:
            raise ValueError(f"the configuration's settings (configured, "
                             f"the port's default) differ: {bad}")
        calib = pcalib.Calibration.from_numpy(cal["cam_k"], cal["pro_k"],
                                              cal["rot"], cal["trans"])
        self.tables = pcalib.build_tables(calib, s["cam_h"], s["cam_w"],
                                          self.device)

    # The glue the other cells' program object uses: the pageable copy,
    # the fetch, the pinned host blocks.
    to_dev = program.Program.to_dev
    fetch = staticmethod(program.Program.fetch)
    warm_host_blocks = program.Program.warm_host_blocks

    def decode_first(self, parts: List[torch.Tensor]):
        return ppipeline.decode_first_frame(parts[0], parts[1], self.tables,
                                            self.cfg)

    def decode_spatial(self, images: torch.Tensor, anchor: torch.Tensor):
        """``run_replay``'s spatial re-anchor with the configuration's
        settings: ``decode_spatial_frame`` anchored on ``anchor``."""
        sp = self.sp
        return ppipeline.decode_spatial_frame(
            images, self.tables, self.cfg, float(sp["period"]),
            anchor=anchor, min_modulation=float(sp["min_modulation"]),
            unwrap_iters=int(sp["unwrap_iters"]),
            filter_depth=bool(sp["filter_depth"]), mg=bool(sp["mg"]))


class Sequence:
    def __init__(self, stack: List[np.ndarray], phases: np.ndarray,
                 surface, dz: float):
        self.stack = stack          # frame-0 [Gray, phase] host u8 parts
        self.phases = phases        # (F-1, N, H, W) host u8, frames 1..
        self.surface = surface      # frame 0's surface
        self.dz = dz                # its motion along z a frame

    def at(self, f: int):
        return scenes.offset(self.surface, self.dz * f)


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.c = cell.config
        self.tr = cell.traffic
        self.cal = scenes.calibration(self.c)
        self.n_frames = int(self.tr["frames"])
        rng = np.random.default_rng([cell.seed % 2**63, 1])
        self.drawn = set(map(int, rng.choice(
            np.arange(1, self.n_frames),
            size=min(int(self.tr["checked_frames"]), self.n_frames - 1),
            replace=False)))
        #: (instance, frame) -> (sequence, frame, anchor P, P, z on host)
        self.kept: Dict[tuple, tuple] = {}
        self.checked = "nothing"

    # --- set-up -------------------------------------------------------

    def render(self) -> List[Sequence]:
        """The cell's sequences, rendered on the device from the seed and
        moved to host memory."""
        tr, c = self.tr, self.c
        s = c["system"]
        rng = np.random.default_rng([self.cell.seed % 2**63, 0])
        ren = scenes.renderer(c, self.cal, self.cell.device, self.cell.seed,
                              tr["noise_sigma"])
        period = float(c["spatial"]["period"])
        steps, b = s["phase_steps"], 2 * s["gray_bits"]
        seqs = []
        # The sphere first: its CG takes 4 or 6 iterations a map by the
        # drawn sphere, the plane's 5, so the window always plays the
        # whole sphere sequence and the plane fills the rest; the
        # check's drawn frames fall on the sphere's rim.
        for i in range(int(tr["sequences"])):
            if i % 2 == 1:
                gx, gy = rng.uniform(*tr["tilt"], size=2)
                surf = scenes.plane(rng.uniform(*tr["z0"]), gx, gy)
            else:
                cxy = rng.uniform(*tr["center_xy"], size=2)
                surf = scenes.sphere(
                    (cxy[0], cxy[1], rng.uniform(*tr["center_z"])),
                    rng.uniform(*tr["radius"]),
                    rng.uniform(*tr["background_z"]))
            dz = float(rng.uniform(*tr["dz_per_frame"]))
            imgs = ren.gray_phase(surf).cpu().numpy()
            stack = [np.ascontiguousarray(imgs[:b]),
                     np.ascontiguousarray(imgs[b:])]
            seq = Sequence(stack, np.empty((self.n_frames - 1, steps,
                                            s["cam_h"], s["cam_w"]),
                                           np.uint8), surf, dz)
            for f0 in range(1, self.n_frames, RENDER_CHUNK):
                fs = range(f0, min(f0 + RENDER_CHUNK, self.n_frames))
                seq.phases[f0 - 1:fs[-1]] = torch.stack(
                    [phase_stack(ren, seq.at(f), steps, period)
                     for f in fs]).cpu().numpy()
            seqs.append(seq)
        return seqs

    def prepare(self):
        """The cell's inputs, without the program (the control needs
        only these)."""
        self.seqs = self.render()

    def setup(self):
        self.prepare()
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.cell.device)
        self.prog = Program(self.c, self.cal, self.cell.device)
        # Every sequence's decode and first spatial maps once; then
        # enough pinned host blocks for the maps the window keeps.
        # The harness's spans time the window alone.
        for s in range(len(self.seqs)):
            self.play(s, int(self.tr["warmup_frames"]), float("inf"),
                      Tally(), None, lambda name: contextlib.nullcontext())
        self.prog.warm_host_blocks(2 * len(self.drawn) + 6)

    # --- the window ---------------------------------------------------

    def play(self, s: int, n: int, deadline: float, tally: Tally,
             keep, sp=None) -> None:
        """Sequence ``s`` for ``n`` frames or until the deadline; records
        each map in ``tally`` and hands it to ``keep(f, anchor, P, z)``
        if given; ``sp`` makes the spans (default: the harness's)."""
        p, now = self.prog, time.perf_counter
        sp = self.cell.spans if sp is None else sp
        seq = self.seqs[s]
        t0 = now()
        with sp("decode.h2d"):
            parts = [p.to_dev(a) for a in seq.stack]
        with sp("decode.first_gray"):
            res = p.decode_first(parts)
        with sp("stream.fetch"):
            z = p.fetch(res)
        tally.add(t0)
        if keep is not None:
            keep(0, None, res.proj_u, z)
        anchor = res.proj_u
        for f in range(1, n):
            if now() > deadline:
                return
            t0 = now()
            with sp("decode.h2d"):
                images = p.to_dev(seq.phases[f - 1])
            with sp("spatial.run"):
                res = p.decode_spatial(images, anchor)
            with sp("stream.fetch"):
                z = p.fetch(res)
            tally.add(t0)
            if keep is not None:
                keep(f, anchor, res.proj_u, z)
            anchor = res.proj_u

    def window(self, seconds: float) -> Window:
        tally = Tally()
        deadline = tally.t0 + seconds
        last: List[Optional[tuple]] = [None]
        i = 0
        while True:
            s = i % len(self.seqs)

            def keep(f, anchor, pu, z, i=i, s=s):
                last[0] = ((i, f), (s, f, anchor, pu, z))
                if i == 0 and (f == 0 or f in self.drawn):
                    self.kept[(i, f)] = (s, f, anchor, pu, z)
            self.play(s, self.n_frames, deadline, tally, keep)
            if time.perf_counter() > deadline:
                break
            i += 1
        win = tally.window()
        key, value = last[0]
        self.kept[key] = value
        return win

    def release(self):
        self.prog = None

    # --- the check ----------------------------------------------------

    def _reference(self):
        s = self.c["system"]
        return plain.build_tables(self.cal, s["cam_h"], s["cam_w"],
                                  self.cell.device)

    def _truth(self):
        """The renderer's projector map of a surface, float64."""
        ren = scenes.renderer(self.c, self.cal, self.cell.device, 0, 0.0)
        return lambda surface: ren.geometry(surface)[1]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.cell.device)

    def check(self) -> Dict[str, float]:
        """Each kept map against the reference's decode of its images:
        frame 0 by the Gray + phase decode, a spatial frame by the
        spatial decode from the same anchor; and each spatial frame's
        fringe order against the renderer's."""
        t = self._reference()
        numbers = Numbers(self.cell.checks["bars"], self.c)
        truth = self._truth()
        sysc, spc = self.c["system"], self.c["spatial"]
        for _, (s, f, anchor, pu, z) in sorted(self.kept.items()):
            seq = self.seqs[s]
            if f == 0:
                z_ref, pu_ref = plain.decode_grayphase(
                    self._dev(seq.stack[0]), self._dev(seq.stack[1]), t,
                    sysc)
                numbers.first(z, pu, z_ref, pu_ref)
                continue
            z_ref, pu_ref, _ = spatial.decode_spatial(
                self._dev(seq.phases[f - 1]), t, sysc, spc, anchor)
            numbers.rescan(z, pu, z_ref, pu_ref, truth(seq.at(f)))
        self.checked = f"{len(self.kept)} maps {sorted(self.kept)}"
        return numbers.result()

    def control(self, dt) -> Dict[str, float]:
        """The reference computed in ``dt`` in the program's place on the
        first sequence a run plays, against the reference in float32:
        frame 0, and each drawn frame decoded from the float32
        reference's own map of the frame before, by both."""
        t = self._reference()
        numbers = Numbers(self.cell.checks["bars"], self.c)
        truth = self._truth()
        sysc, spc = self.c["system"], self.c["spatial"]
        seq = self.seqs[0]
        g, ph = self._dev(seq.stack[0]), self._dev(seq.stack[1])
        z_ref, anchor = plain.decode_grayphase(g, ph, t, sysc)
        z, pu = plain.decode_grayphase(g, ph, t, sysc, dt)
        numbers.first(z, pu, z_ref, anchor)
        for f in range(1, max(self.drawn) + 1):
            images = self._dev(seq.phases[f - 1])
            if f in self.drawn:
                z, pu, _ = spatial.decode_spatial(images, t, sysc, spc,
                                                  anchor, dt)
            z_ref, pu_ref, _ = spatial.decode_spatial(images, t, sysc, spc,
                                                      anchor)
            if f in self.drawn:
                numbers.rescan(z, pu, z_ref, pu_ref, truth(seq.at(f)))
            anchor = pu_ref
        return numbers.result()


def phase_stack(ren: scenes.Renderer, surface, steps: int,
                period: float) -> torch.Tensor:
    """The N phase images of one frame, (N, H, W) u8 on the device: the
    phase part of the frame-0 budget (``Renderer.gray_phase``)."""
    _, pu = ren.geometry(surface)
    return ren.quantize(torch.stack(
        [scenes.fringe_at(pu, k, steps, period) for k in range(steps)]))


class Numbers:
    """A re-scan cell's compared numbers: frame 0 pixel by pixel in P and
    z (``decode_off_share``); each spatial map pixel by pixel in P and z
    inside a 1-px border (``rescan_off_share``), and its global fringe
    order, |median over decoded pixels of (P - P_true)| / T
    (``rescan_global_slip``). Each is the worst over the maps."""

    def __init__(self, bars: dict, config: dict):
        self.bars = bars
        self.period = float(config["spatial"]["period"])
        self.dec: List[float] = []
        self.off: List[float] = []
        self.slip: List[float] = []

    def first(self, z, pu, z_ref, pu_ref):
        self.dec.append(compare.decode_off(z, pu, z_ref, pu_ref,
                                           self.bars["decode"]))

    def rescan(self, z, pu, z_ref, pu_ref, pu_true):
        bar = self.bars["rescan"]
        dev = pu_ref.device
        z, pu = z.to(dev, torch.float32), pu.to(dev, torch.float32)
        inner = (slice(1, -1), slice(1, -1))
        m = (compare.off_mask(z[inner], z_ref[inner], bar["z"])
             | compare.off_mask(pu[inner], pu_ref[inner], bar["proj_u"]))
        self.off.append(compare.share(m))
        self.slip.append(global_slip(pu, pu_true, self.period))

    def result(self) -> Dict[str, float]:
        return {"decode_off_share": compare.worst(self.dec),
                "rescan_off_share": compare.worst(self.off),
                "rescan_global_slip": compare.worst(self.slip)}


def global_slip(pu: torch.Tensor, pu_true: torch.Tensor,
                period: float) -> float:
    """|median over decoded pixels (P != 0) of (P - P_true)| in periods;
    infinite where a value is not finite, NaN where nothing decoded."""
    d = pu.double() - pu_true.to(pu.device, torch.float64)
    d = d[pu != 0]
    if not d.numel():
        return float("nan")
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return abs(float(d.median())) / period
