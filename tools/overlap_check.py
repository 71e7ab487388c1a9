#!/usr/bin/env python3
"""The streaming loop's transfer/compute overlap on one CUDA card, for
this checkout and others, as tests/test_torch_cuda.py's
``test_streaming_hides_transfers`` measures it.

    python3 tools/overlap_check.py [OTHER_TREE ...] [--rounds 3]

Renders the test's scene once (1216x1632, the plane moving 0.05 a frame,
stripe period 12, noise 1, 9 frames) with this checkout's ``synth``,
then runs ``streaming.measure_overlap`` on frames 1-8 from each tree in
turns (this checkout first, then each OTHER_TREE; the order reversed on
every other round), each reading in its own process: three calls, the
best by overlap efficiency, as the test takes it. Prints each reading's
legs (compute, transfer, pipelined, sequential ms per frame), speedup
and efficiency, and whether it meets the test's bars (speedup > 1.1,
efficiency >= 0.5); at the end every reading by tree, in the order
taken. A tree is any directory holding ``slc_tpu_torch/``, such as a
``git archive`` of the parent under the git-ignored ``.trees/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, ".overlap_work")
H, W, N = 1216, 1632, 9

CHILD = r"""
import json, sys
import numpy as np
import torch
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import init_tracker
from slc_tpu_torch.streaming import measure_overlap
h, w = {h}, {w}
d = np.load(sys.argv[1])
dev = torch.device("cuda", 0)
cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
tables = build_tables(synthetic_calibration(cam_h=h, cam_w=w, pro_h=h,
                                            pro_w=w), h, w, dev)
frames = d["frames"]
state = init_tracker(torch.from_numpy(frames[0]).to(dev),
                     torch.from_numpy(d["pu0"]).to(dev),
                     torch.from_numpy(d["z0"]).to(dev), cfg)
calls = [measure_overlap(state, list(frames[1:]), tables, cfg)
         for _ in range(3)]
print(json.dumps(calls))
"""


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()


def render(path):
    sys.path.insert(0, REPO)
    import numpy as np
    from slc_tpu_torch import synth
    from slc_tpu_torch.calib import synthetic_calibration
    from slc_tpu_torch.config import SystemConfig
    cfg = SystemConfig(cam_h=H, cam_w=W, pro_h=H, pro_w=W)
    calib = synthetic_calibration(cam_h=H, cam_w=W, pro_h=H, pro_w=W)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, N, z0=50.0, dz_per_frame=0.05, stripe_period=12,
        noise_sigma=1.0)
    np.savez(path, frames=frames, pu0=pus[0].astype(np.float32),
             z0=zs[0].astype(np.float32))


def reading(tree, data):
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(h=H, w=W), data], cwd=tree,
        env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr}")
    calls = json.loads(proc.stdout.strip().splitlines()[-1])
    return max(calls, key=lambda c: c["overlap_efficiency"]), calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="other trees to time")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    trees = [REPO] + [os.path.abspath(t) for t in args.trees]
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        data = os.path.join(WORK, "scene.npz")
        render(data)
        card = card_line()
        print(card, flush=True)
        taken = []
        for r in range(args.rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                best, calls = reading(tree, data)
                ok = (best["speedup_vs_sequential"] > 1.1
                      and best["overlap_efficiency"] >= 0.5)
                name = os.path.relpath(tree, REPO)
                taken.append((name, best, ok))
                print(f"{name} on {card}: best of 3 {json.dumps(best)}; "
                      f"the test's bars {'met' if ok else 'MISSED'}; "
                      f"speedups of the 3 calls "
                      f"{[c['speedup_vs_sequential'] for c in calls]}",
                      flush=True)
        for name in dict.fromkeys(n for n, _, _ in taken):
            rows = [(b["speedup_vs_sequential"], b["overlap_efficiency"])
                    for n, b, _ in taken if n == name]
            print(f"{name}: (speedup, efficiency) in the order taken {rows}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
