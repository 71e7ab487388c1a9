"""Multi-view sweeps, closed loop: per job one head's sweep of V
overlapping views of an object, each view decoded absolutely as the scan
cell decodes a stack, then the V depth maps registered jointly on the
card.

Per job: per view its pattern stack to the device (a pageable copy, as
``run_replay``'s ``to_dev``) and the Gray + phase decode, through the scan
cell's ``Program.upload`` and ``Program.decode``; the V maps stacked on
the card and handed to ``fusion_frontend.register_scans`` with the
sweep's initial poses and the configuration's ``fusion`` settings; the V
poses read to the host; then the V z maps (``fetch_z_async``, waited on).
The job's V maps count in the window when its poses are on the host, each
with the job's start as its start. Harness spans: ``fuse.views`` (the
copies and decodes), ``fuse.register`` (the registration and the poses'
read-back) and ``stream.fetch`` (the z maps).

A sweep's views look at ``posed``'s scene from its orbit, rendered by
``scenes.Renderer``. Traffic parameters (``traffic/<mix>.json``):
``sweeps`` distinct sweeps played in turn, each with its own scene
``shift`` in x and y drawn uniformly from the range, and its own draw of
the initial poses (``rot_sigma`` rad and ``trans_sigma`` a component,
normal; view 0 exact); ``noise_sigma``.

The check, after the window, on the first job of each sweep and the last
job the window completed: every view of those jobs against the
reference's decode of its stack (``decode_off_share``); each job's poses
against the plain reference's registration (``reference/fusion.py``) of
the program's own maps from the same initial poses (``fuse_pose_gap``),
and against the true poses (``fuse_ate_share``: the absolute trajectory
error relative to view 0, over that of the job's initial poses).
``fuse_pose_gap``'s limit comes from ``Driver.order_control`` (the
reference against itself summed in another order) beside the program's
own readings (``calibrate.py --order-seeds``).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

import slc_tpu_torch.calib as pcalib
import slc_tpu_torch.config as pconfig
import slc_tpu_torch.fusion_frontend as pfront
from slcbench import compare, posed, program, scenes
from slcbench.harness import Cell, Tally, Window
from slcbench.reference import fusion as rfusion
from slcbench.reference import plain


class Program:
    """The system under test for a sweep configuration: the tables and the
    camera matrix on the device, built once; the scan cell's upload,
    decode and fetch; the port's ``register_scans``, looked up on its
    module at call time so that a test can put a broken one in its
    place."""

    def __init__(self, config: dict, cal: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        s = config["system"]
        self.cfg = pconfig.SystemConfig(**s)
        self.mode = config["decode"]
        if self.mode != "grayphase":
            raise ValueError(f"a sweep decodes Gray + phase, not "
                             f"{self.mode!r}")
        self.fusion = config["fusion"]
        calib = pcalib.Calibration.from_numpy(cal["cam_k"], cal["pro_k"],
                                              cal["rot"], cal["trans"])
        self.tables = pcalib.build_tables(calib, s["cam_h"], s["cam_w"],
                                          self.device)
        self.cam_k = torch.from_numpy(cal["cam_k"]).to(self.device)

    to_dev = program.Program.to_dev
    upload = program.Program.upload
    decode = program.Program.decode
    fetch = staticmethod(program.Program.fetch)
    warm_host_blocks = program.Program.warm_host_blocks

    def register(self, depths: torch.Tensor, rot0: np.ndarray,
                 trans0: np.ndarray):
        f = self.fusion
        return pfront.register_scans(
            depths, self.cam_k, rot0, trans0, rounds=int(f["rounds"]),
            gn_iters=int(f["gn_iters"]), grid_step=int(f["grid_step"]),
            max_depth_err=float(f["max_depth_err"]),
            normal_radius=int(f["normal_radius"]),
            anchor_gauge=bool(f["anchor_gauge"]), device=self.device)


class Sweep:
    def __init__(self, stacks: List[list], rot_gt, trans_gt, rot0, trans0):
        self.stacks = stacks        # per view [Gray, phase] host u8 parts
        self.rot_gt, self.trans_gt = rot_gt, trans_gt     # float64
        self.rot0 = rot0.astype(np.float32)               # initial poses
        self.trans0 = trans0.astype(np.float32)


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.c = cell.config
        self.tr = cell.traffic
        self.cal = scenes.calibration(self.c)
        self.views = int(self.c["fusion"]["views"])
        #: job -> (sweep, z maps on the host, rot, trans on the host)
        self.kept: Dict[int, tuple] = {}
        self.checked = "nothing"

    # --- set-up -------------------------------------------------------

    def render(self) -> List[Sweep]:
        tr = self.tr
        rng = np.random.default_rng([self.cell.seed % 2**63, 0])
        ren = scenes.renderer(self.c, self.cal, self.cell.device,
                              self.cell.seed, tr["noise_sigma"])
        rot_gt, trans_gt = posed.orbit(self.views)
        sweeps = []
        for _ in range(int(tr["sweeps"])):
            shift = rng.uniform(*tr["shift"], size=2)
            rot0, trans0 = posed.perturb(rng, rot_gt, trans_gt,
                                         float(tr["rot_sigma"]),
                                         float(tr["trans_sigma"]))
            stacks = [scenes.pattern_stack(
                ren, self.c, posed.surface(rot_gt[v], trans_gt[v], shift))
                for v in range(self.views)]
            sweeps.append(Sweep(stacks, rot_gt, trans_gt, rot0, trans0))
        return sweeps

    def prepare(self):
        """The cell's inputs, without the program (the control needs
        only these)."""
        self.sweeps = self.render()

    def setup(self):
        self.prepare()
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.cell.device)
        self.prog = Program(self.c, self.cal, self.cell.device)
        # One whole job warms every shape, outside the harness's spans
        # (they time the window alone); then enough pinned host blocks for
        # the maps of the jobs the window keeps and the one in flight.
        self.job(self.sweeps[0], Tally(),
                 lambda name: contextlib.nullcontext())
        self.prog.warm_host_blocks((len(self.sweeps) + 2) * self.views + 4)

    # --- the window ---------------------------------------------------

    def job(self, sweep: Sweep, tally: Tally, sp=None):
        """One sweep: returns (z maps on the host, rot, trans on the
        host); ``sp`` makes the spans (default: the harness's)."""
        p = self.prog
        sp = self.cell.spans if sp is None else sp
        t0 = time.perf_counter()
        with sp("fuse.views"):
            results = [p.decode(p.upload(stack)) for stack in sweep.stacks]
            depths = torch.stack([r.z for r in results])
        with sp("fuse.register"):
            rot, trans = p.register(depths, sweep.rot0, sweep.trans0)
            rot, trans = rot.cpu(), trans.cpu()
        for _ in results:
            tally.add(t0)
        with sp("stream.fetch"):
            zs = [p.fetch(r) for r in results]
        return zs, rot, trans

    def window(self, seconds: float) -> Window:
        tally = Tally()
        deadline = tally.t0 + seconds
        j = 0
        while True:
            s = j % len(self.sweeps)
            out = self.job(self.sweeps[s], tally)
            if j < len(self.sweeps):
                self.kept[j] = (s, *out)
            last = (j, (s, *out))
            if time.perf_counter() > deadline:
                break
            j += 1
        win = tally.window()
        self.kept[last[0]] = last[1]
        return win

    def release(self):
        self.prog = None

    # --- the check ----------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.cell.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.cell.device)

    def _decode(self, stack, tables, dt=torch.float32):
        return plain.decode_grayphase(self._dev(stack[0]),
                                      self._dev(stack[1]), tables,
                                      self.c["system"], dt)

    def _tables(self):
        s = self.c["system"]
        return plain.build_tables(self.cal, s["cam_h"], s["cam_w"],
                                  self.cell.device)

    def check(self) -> Dict[str, float]:
        t = self._tables()
        numbers = Numbers(self.cell.checks["bars"])
        for s, zs, rot, trans in self.kept.values():
            sweep = self.sweeps[s]
            for z, stack in zip(zs, sweep.stacks):
                numbers.decode(z, *self._decode(stack, t))
            depths = torch.stack([self._dev(z) for z in zs])
            numbers.poses(rot, trans, depths, self.cal["cam_k"], sweep,
                          self.c["fusion"])
        self.checked = (f"{len(self.kept)} jobs {sorted(self.kept)}, "
                        f"{self.views} views each")
        return numbers.result()

    def control(self, dt, tf32: bool = False) -> Dict[str, float]:
        """The reference in ``dt`` (with TF32 matrix products given
        ``tf32``) in the program's place on the first sweep: the decode
        of every view and the registration of those maps, held against
        the reference in float32 as a run's check holds the program."""
        t = self._tables()
        numbers = Numbers(self.cell.checks["bars"])
        sweep = self.sweeps[0]
        zs = []
        for stack in sweep.stacks:
            z, _ = self._decode(stack, t, dt)
            numbers.decode(z, *self._decode(stack, t))
            zs.append(z)
        depths = torch.stack(zs)
        try:
            rot, trans = rfusion.register(depths, self.cal["cam_k"],
                                          sweep.rot0, sweep.trans0,
                                          self.c["fusion"], dt, tf32)
        except rfusion.Singular:
            # A registration that met a singular system has no poses.
            rot = torch.full((self.views, 3, 3), math.nan)
            trans = torch.full((self.views, 3), math.nan)
        numbers.poses(rot, trans, depths.float(), self.cal["cam_k"], sweep,
                      self.c["fusion"])
        return numbers.result()

    def order_control(self, order=None) -> Dict[str, object]:
        """The reference against itself with its landmark order permuted,
        on the first job of each sweep: the maps the reference decodes in
        float32, registered from the sweep's initial poses once in the
        reference's order and once with every Gauss-Newton step's (and
        the anchor gauge's) landmarks permuted, by permutations drawn from
        the seed (``order``, given, maps a landmark count to its
        permutation). ``fuse_pose_gap`` is the largest gap between the two
        registrations, ``gaps`` each sweep's: the spread that any sound
        float32 implementation of these sums may show, whatever the
        program does."""
        if order is None:
            gen = torch.Generator().manual_seed(self.cell.seed % 2**63)

            def order(n):
                return torch.randperm(n, generator=gen)
        t = self._tables()
        gaps = []
        for sweep in self.sweeps:
            depths = torch.stack([self._decode(stack, t)[0]
                                  for stack in sweep.stacks])
            args = (depths, self.cal["cam_k"], sweep.rot0, sweep.trans0,
                    self.c["fusion"])
            rot, trans = rfusion.register(*args)
            r_p, t_p = rfusion.register(*args, order=order)
            gaps.append(rfusion.pose_gap(r_p, t_p, rot, trans))
        return {"fuse_pose_gap": worst(gaps), "gaps": gaps}


class Numbers:
    """A sweep cell's compared numbers, each the worst over what was
    compared: ``decode_off_share`` (the scan cell's, per view),
    ``fuse_pose_gap`` (the largest gap of a rotation entry or translation
    component to the reference's registration of the same maps) and
    ``fuse_ate_share`` (the poses' absolute trajectory error to the
    true ones over that of the initial poses)."""

    def __init__(self, bars: dict):
        self.bars = bars
        self.dec: List[float] = []
        self.gap: List[float] = []
        self.ate: List[float] = []

    def decode(self, z, z_ref, pu_ref):
        self.dec.append(compare.decode_off(z, None, z_ref, pu_ref,
                                           self.bars["decode"]))

    def poses(self, rot, trans, depths, cam_k, sweep: Sweep, settings):
        r_ref, t_ref = rfusion.register(depths, cam_k, sweep.rot0,
                                        sweep.trans0, settings)
        self.gap.append(rfusion.pose_gap(rot, trans, r_ref, t_ref))
        self.ate.append(
            rfusion.ate_rmse(rot, trans, sweep.rot_gt, sweep.trans_gt)
            / rfusion.ate_rmse(sweep.rot0, sweep.trans0, sweep.rot_gt,
                               sweep.trans_gt))

    def result(self) -> Dict[str, float]:
        return {"decode_off_share": compare.worst(self.dec),
                "fuse_pose_gap": worst(self.gap),
                "fuse_ate_share": worst(self.ate)}


def worst(values: List[float]) -> float:
    """The largest value; NaN where one is NaN or none was compared (a
    NaN fails)."""
    if not values or any(math.isnan(v) for v in values):
        return float("nan")
    return max(values)
