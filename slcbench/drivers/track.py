"""Tracked sequences, closed loop: per sequence one absolute decode of
frame 0, then the phase-locked tracker on every later frame, each depth
map fetched to the host before the next frame is handed over.

Per sequence, as ``run_replay`` runs it in stream mode: the frame-0
pattern stack to the device, the decode, its z to the host (map 0), the
lock window from the frame-0 map, the period diagnostic, the tracker's
init; then per frame ``HostStager.put`` one frame ahead, the locked
``dynamic_step`` and ``fetch_z_async``, waited on. A map's latency runs
from the start of the stack's copy (map 0) or the frame's ``put`` to its
z on the host.

Traffic parameters (``traffic/<mix>.json``): ``sequences`` distinct
sequences played in turn, ``frames`` per sequence, a plane of depth
``z0`` tilted by ``tilt`` (gx, gy) moving ``dz_per_frame`` a frame, each
drawn uniformly from its [low, high] range by the seed; ``noise_sigma``;
``checked_frames`` tracked frames drawn by the seed from those after the
check's ``pixel_frames`` and compared besides frame 0, those and the
last; ``warmup_frames`` per sequence in set-up.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from slcbench import compare, scenes
from slcbench.harness import Cell, Tally, Window
from slcbench.program import Program

#: Frames rendered on the device at once (bounds the renderer's memory).
RENDER_CHUNK = 20
#: The precision of the reference the check holds the program's float32
#: maps to. On some sequences the float32 reference parts from float64
#: in whole row bands (the lock gates its correction per 64-row band),
#: while the program stays within the bars of float64: a band that
#: float32 rounding turned in the reference is no fault of the program.
REFERENCE_DTYPE = torch.float64


class Sequence:
    def __init__(self, stack: List[np.ndarray], frames: np.ndarray):
        self.stack = stack          # frame-0 pattern stack, host u8 parts
        self.frames = frames        # (F, H, W) host u8 stripe frames


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.c = cell.config
        self.tr = cell.traffic
        self.cal = scenes.calibration(self.c)
        self.n_frames = int(self.tr["frames"])
        rng = np.random.default_rng([cell.seed % 2**63, 1])
        n_seq = int(self.tr["sequences"])
        # The instance checked besides the last one the window completes,
        # and the tracked frames compared in each.
        self.drawn = int(rng.integers(0, 2 * n_seq))
        last = self.n_frames - 1
        bars = cell.checks["bars"]["track"]
        self.pixel_frames = set(range(1, min(int(bars["pixel_frames"]),
                                             last - 1) + 1))
        later = np.arange(len(self.pixel_frames) + 1, last)
        picks = rng.choice(later, size=min(int(self.tr["checked_frames"]),
                                           len(later)), replace=False)
        self.check_frames = sorted({0, last, *self.pixel_frames,
                                    *map(int, picks)})
        self.kept: Dict[int, tuple] = {}
        self.checked = "nothing"

    # --- set-up -------------------------------------------------------

    def render(self) -> List[Sequence]:
        """The cell's sequences, rendered on the device from the seed and
        moved to host memory."""
        tr, c = self.tr, self.c
        rng = np.random.default_rng([self.cell.seed % 2**63, 0])
        ren = scenes.renderer(c, self.cal, self.cell.device, self.cell.seed,
                              tr["noise_sigma"])
        seqs = []
        for _ in range(int(tr["sequences"])):
            z0 = rng.uniform(*tr["z0"])
            gx, gy = rng.uniform(*tr["tilt"], size=2)
            dz = rng.uniform(*tr["dz_per_frame"])
            base = scenes.plane(z0, gx, gy)
            stack = scenes.pattern_stack(ren, c, base)
            frames = np.empty((self.n_frames, c["system"]["cam_h"],
                               c["system"]["cam_w"]), np.uint8)
            for f0 in range(0, self.n_frames, RENDER_CHUNK):
                fs = range(f0, min(f0 + RENDER_CHUNK, self.n_frames))
                frames[f0:fs[-1] + 1] = ren.stripes(
                    [scenes.offset(base, dz * f) for f in fs],
                    float(c["stripe_period"])).cpu().numpy()
            seqs.append(Sequence(stack, frames))
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
        # Every sequence's decode, window and first steps once; then
        # enough pinned host blocks for the maps the window keeps.
        for seq in self.seqs:
            self.play(seq, int(self.tr["warmup_frames"]), float("inf"),
                      Tally(), None)
        self.prog.warm_host_blocks(4 * len(self.check_frames))

    # --- the window ---------------------------------------------------

    def play(self, seq: Sequence, n: int, deadline: float,
             tally: Tally, keep) -> bool:
        """One sequence of ``n`` frames; records each map in ``tally``;
        keeps the checked maps in ``keep`` (a dict) if given.
        Returns whether it ran to its end before the deadline."""
        p, sp, now = self.prog, self.cell.spans, time.perf_counter
        t0 = now()
        with sp("track.seq_setup"):
            first = p.decode(p.upload(seq.stack))
            with sp("stream.fetch"):
                z0 = p.fetch(first)
            tally.add(t0)
            pu0 = first.proj_u.cpu().numpy()
            win = p.lock_window(pu0)
            p.estimate_period(seq.frames[0], first.proj_u, win)
            state = p.init_tracker(seq.frames[0], first)
        if keep is not None:
            keep[0] = (z0, pu0)
        if now() > deadline:
            return False
        put_t = {1: now()}
        with sp("stream.put"):
            pending = p.stager.put(seq.frames[1])
        for f in range(1, n):
            nxt = None
            if f + 1 < n:
                put_t[f + 1] = now()
                with sp("stream.put"):
                    nxt = p.stager.put(seq.frames[f + 1])
            with sp("track.step"):
                state, res = p.step(state, pending.wait(), win)
            with sp("stream.fetch"):
                z = p.fetch(res)
            tally.add(put_t.pop(f))
            if keep is not None and f in self.check_frames:
                keep[f] = (z, None)
            if now() > deadline:
                return f + 1 == n
            pending = nxt
        return True

    def window(self, seconds: float) -> Window:
        tally = Tally()
        deadline = tally.t0 + seconds
        i, last = 0, None
        while True:
            s = i % len(self.seqs)
            keep: Dict[int, tuple] = {}
            done = self.play(self.seqs[s], self.n_frames, deadline, tally,
                             keep)
            if done:
                if i == self.drawn:
                    self.kept[i] = (s, keep)
                last = (i, s, keep)
            if time.perf_counter() > deadline:
                break
            i += 1
        win = tally.window()
        if last is not None:
            self.kept[last[0]] = last[1:]
        return win

    def release(self):
        self.prog = None

    # --- the check ----------------------------------------------------

    def check(self) -> Dict[str, float]:
        """The kept maps of each checked sequence against the reference
        run over the same images in float64 (``REFERENCE_DTYPE``)."""
        ref = compare.Reference(self.c, self.cal, self.cell.device)
        numbers = Numbers(self.cell.checks["bars"], self.pixel_frames)
        for i, (s, keep) in sorted(self.kept.items()):
            seq = self.seqs[s]
            for f, z_ref, pu_ref in ref.track(seq.stack, seq.frames,
                                              REFERENCE_DTYPE):
                if f in keep:
                    numbers.add(f, keep[f][0], keep[f][1], z_ref, pu_ref)
        self.checked = (f"{len(self.kept)} sequence(s) "
                        f"{sorted(self.kept)}, frames {self.check_frames}")
        return numbers.result()

    def control(self, dt) -> Dict[str, float]:
        """The reference computed in ``dt`` in the program's place, on the
        sequences a run checks first (the drawn one and sequence 0),
        against the reference in float64, as a run's check holds the
        program."""
        ref = compare.Reference(self.c, self.cal, self.cell.device)
        numbers = Numbers(self.cell.checks["bars"], self.pixel_frames)
        for s in sorted({self.drawn % len(self.seqs), 0}):
            seq = self.seqs[s]
            for (f, z_ref, pu_ref), (_, z, pu) in zip(
                    ref.track(seq.stack, seq.frames, REFERENCE_DTYPE),
                    ref.track(seq.stack, seq.frames, dt)):
                if f in self.check_frames:
                    numbers.add(f, z, pu, z_ref, pu_ref)
        return numbers.result()


class Numbers:
    """A tracked cell's compared numbers, each map against the reference
    in float64 (its z rounded to float32). The frame-0 decode and the
    first tracked frames (the check's ``pixel_frames``) are compared
    pixel by pixel; later frames by quantiles of the gap (the check's
    ``gap_quantiles``, a number's name to its quantile), since a correct
    float32 implementation of the tracker parts from the float64 one on
    single pixels (a sub-pixel extremum or a lock reading decided the
    other way by rounding), and the parting spreads over the
    trajectory."""

    def __init__(self, bars: dict, pixel_frames):
        self.bars = bars
        self.pixel_frames = pixel_frames
        self.dec: List[float] = []
        self.early: List[float] = []
        self.gaps: Dict[str, List[float]] = {
            k: [] for k in bars["track"]["gap_quantiles"]}

    def add(self, f, z, pu, z_ref, pu_ref):
        bar = self.bars["track"]
        if f == 0:
            self.dec.append(compare.decode_off(z, pu, z_ref, pu_ref,
                                               self.bars["decode"]))
        elif f in self.pixel_frames:
            self.early.append(compare.share(compare.off_mask(
                z, z_ref, bar["z"])))
        else:
            for k, q in bar["gap_quantiles"].items():
                self.gaps[k].append(compare.gap_quantile(z, z_ref, q))

    def result(self) -> Dict[str, float]:
        return {"decode_off_share": compare.worst(self.dec),
                "track_off_share": compare.worst(self.early),
                **{k: compare.worst(v) for k, v in self.gaps.items()}}
