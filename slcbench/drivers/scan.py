"""Single scans, closed loop: per scan the pattern stack to the device (as
``run_replay``'s ``to_dev`` copies it), the configuration's absolute
decode, and z to the host (``fetch_z_async``, waited on) before the next
scan is handed over. A map's latency runs from the start of the stack's
copy to its z on the host.

Traffic parameters (``traffic/<mix>.json``): ``scans`` distinct stacks
played in turn, alternately of a ``plane`` (``z0``, ``tilt``) and a
``sphere`` (centre ``center_xy``/``center_z``, ``radius``, background
``background_z``) over a background plane, each drawn uniformly from its
[low, high] range by the seed; ``noise_sigma``; ``checked`` scans of the
window drawn by the seed and compared besides the last.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from slcbench import compare, scenes
from slcbench.harness import Cell, Tally, Window
from slcbench.program import Program

#: The drawn scans come from the first DRAW_RANGE of the window.
DRAW_RANGE = 256


class Driver:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.c = cell.config
        self.tr = cell.traffic
        self.cal = scenes.calibration(self.c)
        rng = np.random.default_rng([cell.seed % 2**63, 1])
        self.drawn = set(map(int, rng.choice(
            DRAW_RANGE, size=int(self.tr["checked"]), replace=False)))
        self.kept: Dict[int, tuple] = {}
        self.checked = "nothing"

    def render(self) -> List[list]:
        tr = self.tr
        rng = np.random.default_rng([self.cell.seed % 2**63, 0])
        ren = scenes.renderer(self.c, self.cal, self.cell.device,
                              self.cell.seed, tr["noise_sigma"])
        stacks = []
        for i in range(int(tr["scans"])):
            if i % 2 == 0:
                gx, gy = rng.uniform(*tr["tilt"], size=2)
                surf = scenes.plane(rng.uniform(*tr["z0"]), gx, gy)
            else:
                cxy = rng.uniform(*tr["center_xy"], size=2)
                surf = scenes.sphere(
                    (cxy[0], cxy[1], rng.uniform(*tr["center_z"])),
                    rng.uniform(*tr["radius"]),
                    rng.uniform(*tr["background_z"]))
            stacks.append(scenes.pattern_stack(ren, self.c, surf))
        return stacks

    def prepare(self):
        """The cell's inputs, without the program (the control needs
        only these)."""
        self.stacks = self.render()

    def setup(self):
        self.prepare()
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.cell.device)
        self.prog = Program(self.c, self.cal, self.cell.device)
        for stack in self.stacks[:2]:
            self.scan(stack, Tally())
        self.prog.warm_host_blocks(2 * len(self.drawn) + 4)

    def scan(self, stack, tally: Tally) -> torch.Tensor:
        p, sp, now = self.prog, self.cell.spans, time.perf_counter
        t0 = now()
        with sp("decode.h2d"):
            parts = p.upload(stack)
        with sp("decode.run"):
            res = p.decode(parts)
        with sp("stream.fetch"):
            z = p.fetch(res)
        tally.add(t0)
        return z

    def window(self, seconds: float) -> Window:
        tally = Tally()
        deadline = tally.t0 + seconds
        i = 0
        while True:
            s = i % len(self.stacks)
            z = self.scan(self.stacks[s], tally)
            if i in self.drawn:
                self.kept[i] = (s, z)
            last = (i, s, z)
            if time.perf_counter() > deadline:
                break
            i += 1
        win = tally.window()
        self.kept[last[0]] = last[1:]
        return win

    def release(self):
        self.prog = None

    def check(self) -> Dict[str, float]:
        """Each kept scan's z against the reference's decode of its
        stack."""
        ref = compare.Reference(self.c, self.cal, self.cell.device)
        bars = self.cell.checks["bars"]["decode"]
        offs = []
        for i, (s, z) in sorted(self.kept.items()):
            z_ref, pu_ref = ref.decode(self.stacks[s])
            offs.append(compare.decode_off(z, None, z_ref, pu_ref, bars))
        self.checked = f"{len(self.kept)} scans {sorted(self.kept)}"
        return {"decode_off_share": compare.worst(offs)}

    def control(self, dt) -> Dict[str, float]:
        """The reference decode in ``dt`` in the program's place, on every
        distinct stack, against the reference in float32."""
        ref = compare.Reference(self.c, self.cal, self.cell.device)
        bars = self.cell.checks["bars"]["decode"]
        offs = []
        for stack in self.stacks:
            z_ref, pu_ref = ref.decode(stack)
            z, _ = ref.decode(stack, dt)
            offs.append(compare.decode_off(z, None, z_ref, pu_ref, bars))
        return {"decode_off_share": compare.worst(offs)}
