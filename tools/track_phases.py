#!/usr/bin/env python3
"""Split the track launch's device time by phase, and time the tracking
steps with their inputs in L2 and in device memory, on one CUDA card.

    python3 tools/track_phases.py

The track launch (``track_kernel`` in csrc/dynamic_step.cu) is the whole
open-loop step and the first launch of the locked step. This script
builds this checkout's kernels twice more, with ``-DSLC_TRACK_STOP=1``
(the launch ends after its box sums) and ``=2`` (after the extrema and
the deltaP select), and drives all three libraries through this
checkout's wrappers at 1024x1280 on chip_smoke.py's rendered inputs:

1. the phase split: the kernels-alone device time (``devtime.
   graph_time_s``, 20 calls in one CUDA graph) of the open-loop step and
   of the locked step's track launch (``ablate="track"``) in each build,
   in turns (1, 2, full, full, 2, 1); box sums = build 1, extrema and
   select = build 2 - build 1, the 3x3 mean and integration (open loop:
   and triangulation) = full - build 2;
2. the open-loop step, the track launch and the whole locked step with
   their inputs L2-resident (one input set, as every kernel time of
   chip_smoke.py) and cold: ``devtime.rotating`` over SETS input sets,
   each with its own outputs, whose bytes exceed twice the 50 MB L2, in
   turns (resident, cold, cold, resident).

The stop builds write nothing but a never-taken sink, so their outputs
are garbage; they are profiling builds only.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from slc_tpu_torch import devtime, synth  # noqa: E402
from slc_tpu_torch.calib import build_tables, synthetic_calibration  # noqa
from slc_tpu_torch.config import REFERENCE_CONFIG  # noqa: E402
from slc_tpu_torch.kernels import _build  # noqa: E402
from slc_tpu_torch.kernels import dynamic_step as kstep  # noqa: E402
from slc_tpu_torch.kernels import stripe as kstripe  # noqa: E402
from slc_tpu_torch.ops.demod import suggest_lock_window  # noqa: E402

LOCK_T = 12.0
#: Input sets of the cold timing: each a frame, three carried maps and
#: the step's outputs, ~33-48 MB at 1024x1280.
SETS = 6


def using(lib, fn):
    """``fn`` with this checkout's wrappers calling ``lib``."""
    def call():
        saved, _build._lib = _build._lib, lib
        try:
            return fn()
        finally:
            _build._lib = saved
    return call


def ms(fn) -> float:
    return 1e3 * devtime.graph_time_s(fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("track_phases: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"full": _build.lib()}
    for stop in (1, 2):
        libs[stop] = _build.load(_build.build((f"-DSLC_TRACK_STOP={stop}",)))

    h, w = 1024, 1280
    cfg = dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    frames, _, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, z0=50.0, dz_per_frame=0.3, stripe_period=int(LOCK_T),
        noise_sigma=1.0)
    f0, f1 = (torch.from_numpy(f).to(dev) for f in frames)
    pu0 = torch.from_numpy(pu_gt[0].astype(np.float32)).to(dev)
    sw0, sb0 = kstripe.stripe_regression_ref(f0, cfg.reco_window)
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    lk = dict(kw, period=LOCK_T, win_u=suggest_lock_window(pu_gt[0], LOCK_T),
              win_v=9)
    steps = {
        "open-loop step": lambda a: kstep.dynamic_step_open_cuda(*a, **kw),
        "track launch of the locked step": lambda a:
            kstep.dynamic_step_lock_cuda(*a, **lk, ablate="track"),
        "locked step": lambda a: kstep.dynamic_step_lock_cuda(*a, **lk)}
    one = (f1, sw0, sb0, pu0, tables)

    for name in list(steps)[:2]:
        t = {k: [] for k in libs}
        for k in (1, 2, "full", "full", 2, 1):
            t[k].append(ms(using(libs[k], lambda: steps[name](one))))
        t1, t2, t3 = (sum(t[k]) / 2 for k in (1, 2, "full"))
        print(f"split of the {name} at {h}x{w}, kernels alone (graph of "
              f"20), L2-resident: box sums {t1:.4f} ms, extrema and select "
              f"{t2 - t1:.4f} ms, mean and integration "
              f"{t3 - t2:.4f} ms, whole {t3:.4f} ms (builds: 1 "
              f"{t[1][0]:.4f}/{t[1][1]:.4f}, 2 {t[2][0]:.4f}/{t[2][1]:.4f},"
              f" full {t['full'][0]:.4f}/{t['full'][1]:.4f})", flush=True)

    sets = [tuple(a.clone() for a in one[:4]) + (tables,)
            for _ in range(SETS)]
    mb = SETS * (h * w * 37) / 1e6
    print(f"cold timing: {SETS} input sets with their outputs, "
          f"~{mb:.0f} MB at 37 B/px", flush=True)
    for name, step in steps.items():
        resident = lambda: step(one)  # noqa: E731
        cold = devtime.rotating(step, sets)
        t = [ms(f) for f in (resident, cold, cold, resident)]
        print(f"time {name} at {h}x{w}, kernels alone (graph of 20): "
              f"L2-resident {(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, "
              f"{t[3]:.4f}), cold {(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, "
              f"{t[2]:.4f}) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
