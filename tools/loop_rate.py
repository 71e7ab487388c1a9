#!/usr/bin/env python3
"""The replay loop's rate on one CUDA card, for this checkout and others.

    python3 tools/loop_rate.py [OTHER_TREE ...] [--frames 65] [--rounds 1]
        [--cases none:1,none:8,none:16,npz:1,xyz:1]

Writes one moving-plane dataset at the reference config with this
checkout's ``synth`` CLI (``--scene plane``, stripe period 12, lock on),
then runs ``python -m slc_tpu_torch run`` on it from each tree in turns
(this checkout and each OTHER_TREE, then again in reverse order, so
that a parent and a change alternate on the same card; ``--rounds``
times, the order of the cases reversed on every other turn). Each case
is ``clouds:K``: ``none`` (``--no-clouds``), ``npz`` or ``xyz`` clouds
at ``--chunk`` K (K > 1 skipped where the tree's CLI does not take
``--chunk``). Each run is its own process. From each run's
metrics.jsonl it prints the loop's fps from the end of frame 16 to the
last frame (the sum of the records' 1/fps: whole chunks at K = 8 and 16
when the frame count is 1 plus a multiple of 16), the loop's wall per
frame, the median host wall of ``slc/dynamic_step`` or
``slc/dynamic_chunk`` / K per frame, and the cloud writer's time per
frame, total and device-to-host copy (``writer_total_ms``,
``writer_copy_ms``); at the end every reading of the fps by tree and
case, in the order taken, with their median. A tree is any directory
holding ``slc_tpu_torch/``, such as a ``git archive`` of the parent
under the git-ignored ``.trees/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, ".loop_rate_work")
FIRST = 16


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()


def cli(tree, *argv):
    """``python -m slc_tpu_torch argv`` with ``tree`` first on the path;
    returns (exit code, stderr)."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-m", "slc_tpu_torch", *argv],
                          cwd=tree, env=env, capture_output=True, text=True)
    return proc.returncode, proc.stderr


def summarize(out, k):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    frames = [r for r in recs if "frame" in r]
    idx = next(i for i, r in enumerate(frames) if r["frame"] == FIRST)
    tail = frames[idx + 1:]
    wall = sum(1.0 / r["fps"] for r in tail)
    step = [r["t_dynamic_step_ms"] for r in frames
            if "t_dynamic_step_ms" in r]
    step += [r["t_dynamic_chunk_ms"] / k for r in frames
             if "t_dynamic_chunk_ms" in r]
    fps = len(tail) / wall
    per = 1e3 * wall / len(tail)
    line = (f"fps {fps:.2f} over {len(tail)} frames ({per:.4f} ms a "
            f"frame), step host wall median "
            f"{statistics.median(step):.4f} ms a frame")
    writer = next((r for r in recs if r.get("writer")), None)
    if writer:
        n = writer["writer_frames"]
        line += (f", writer {writer['writer_total_ms'] / n:.3f} ms a frame "
                 f"(device-to-host copy {writer['writer_copy_ms'] / n:.4f})")
    return fps, line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="other checkouts to run")
    ap.add_argument("--frames", type=int, default=65)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", default="none:1,none:8,none:16,npz:1,xyz:1")
    args = ap.parse_args()
    cases = [(c.split(":")[0], int(c.split(":")[1]))
             for c in args.cases.split(",")]
    card = card_line()
    print(card, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    ds = os.path.join(WORK, "ds")
    rc, err = cli(REPO, "synth", ds, "--frames", str(args.frames),
                  "--scene", "plane")
    if rc:
        raise RuntimeError(f"synth failed: {err}")
    calib = os.path.join(ds, "parameters.yml")
    trees = [REPO] + [os.path.abspath(t) for t in args.trees]
    order = (trees + trees[::-1]) * args.rounds
    readings: dict = {}
    try:
        for turn, tree in enumerate(order):
            name = "this" if tree == REPO else os.path.relpath(tree, REPO)
            for fmt, k in (cases if turn % 2 == 0 else cases[::-1]):
                out = os.path.join(WORK, f"o{turn}_{fmt}_{k}")
                argv = ["run", ds, "--calib", calib, "--out", out,
                        "--device", "cuda"]
                if fmt == "none":
                    argv += ["--no-clouds"]
                else:
                    argv += ["--out-format", fmt]
                if k > 1:
                    argv += ["--chunk", str(k)]
                rc, err = cli(tree, *argv)
                if rc and k > 1:
                    print(f"{name}: --chunk {k} not taken", flush=True)
                    continue
                if rc:
                    raise RuntimeError(f"{name} {argv} failed: {err}")
                fps, line = summarize(out, k)
                readings.setdefault((name, fmt, k), []).append(fps)
                print(f"turn {turn} {name} clouds {fmt} --chunk {k} on "
                      f"{card}: {line}", flush=True)
                shutil.rmtree(out)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for (name, fmt, k), fps in readings.items():
        print(f"all readings: {name} clouds {fmt} --chunk {k} on {card}: "
              f"fps {', '.join(f'{x:.2f}' for x in fps)}; median "
              f"{statistics.median(fps):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
