#!/usr/bin/env python3
"""Smoke test of slc_tpu_torch on one CUDA card: build, kernel parity,
the device-timing path, and the replay paths end to end.

    python3 chip_smoke.py

Run from the root of a checkout. In order it:

1. requires CUDA and prints the card (``nvidia-smi``), torch and CUDA;
2. builds the ten CUDA kernels, the lock window's median
   (``csrc/lock_window.cu``), the registration's point-to-plane step
   (``csrc/p2l.cu``) and the frame stager's staging entry
   (``csrc/staging.cu``; these three have no TPU counterpart) from
   ``slc_tpu_torch/kernels/csrc`` into one library (one nvcc per source,
   all started together), and the
   native host I/O library from ``slc_tpu_torch/io/native/slc_io.cpp``
   (g++), and prints the host's CPU;
3. holds each kernel against its plain PyTorch version, both on the card,
   at the reference shape 1024x1280 and a ragged 1000x1270, on rendered
   inputs (a random frame for the stripe kernel, random O(1) levels for
   the multigrid kernels), at the bars of the CPU parity tests; stripe at
   windows 5, 21 and 63, the multigrid kernels at the three level shapes
   of each shape's chain (1024x1280, 512x640, 256x320; 1000x1270,
   500x635, 250x318) and the coarsest level's kernel (``mg_coarse``,
   port-only) at each chain's coarsest, 32x40, exactly, heterodyne at the reference's 3 frequencies x 4
   steps and at HET_GENERIC's 3 x 5 (the kernel's generic instance); the
   stripe and step kernels also in fast sub-pixel mode (``frac_bits=7``)
   against the quantizing plain versions; the access-pattern floors
   exactly; the two-kernel locked step (open-loop step, then the
   standalone lock on its P) bit for bit against the fused one; and the
   lock window's kernel on the decoded frame-0 map and on the true map
   in float32: its n and two middle values of |dP/du| equal to the plain
   numpy version's, and ``suggest_lock_window``'s window from the card
   equal to the host path's;
4. drives the device-timing path (``slc_tpu_torch.devtime``) at
   1024x1280, with the launch counts set to 0 just before and checked
   just after: each kernel and its plain version as the device time of
   the call (CUDA events, plain/kernel/kernel/plain, the mean of 20
   calls after 3 warm-ups), and each kernel's launches alone (20 calls
   captured back to back in one CUDA graph, the mean over 3 replays
   queued behind a spin kernel); the fast sub-pixel
   kernels; the two-kernel vs the fused locked step; the locked step's
   stages (``ablate``); the open-loop and locked steps cold, their inputs
   and outputs rotated over COLD_SETS sets (``devtime.rotating``, over
   twice the card's 50 MB L2), beside their L2-resident times;
   ``mg_down`` and ``mg_up`` at each level shape of the 1024x1280 chain,
   both cold at 1024x1280, heterodyne and bilateral cold, ``mg_coarse``
   at 32x40 (its call and kernels alone, also at one sweep, against the
   plain visit's 467 launches in a graph of 20 visits), and each
   multigrid kernel's
   time per
   preconditioner call (launches per level x time; per spatial decode in
   phase 5, once ``cg_iters`` is known). Where
   ``torch.profiler`` records CUDA kernels
   (CUPTI tracing may be denied), also the plain versions' kernels alone
   and the locked step by launch, from its records; where it does not,
   those lines say "not measured". The lock window's kernel on the
   decoded frame-0 map: its call and its launches alone, and
   ``suggest_lock_window`` by the host clock from a card tensor, a
   float32 host map and a CPU tensor (numpy), in turns. Then one
   roofline line per kernel from its kernels-alone time:
   device ms, bytes per pixel, GB/s, % of the card's HBM peak and, for
   stripe and bilateral, % of the measured floor of their access
   pattern; and its bound, the larger of its bytes over the memory rate
   and its plain version's operations (``devtime.count_ops``) over the
   float32 rate (``bound_ms``, ``bound_by`` in the JSON line; null on a
   card whose peaks devtime does not list). ``library_ms`` is the call
   time of the one PyTorch call that computes the floors' function (a
   broadcast add), checked equal to the plain version; null for the
   other kernels, which no single call computes;
5. runs ``python -m slc_tpu_torch run`` through ``main()``, each run with
   the launch counts and the native I/O counters (``io.native.COUNTS``)
   set to 0 just before it and read just after, and each count required
   to equal what the runner makes: the pool delivers every dynamic frame
   after frame 0, each of which goes to the card through one call of the
   staging entry, the codec reads frame 0's planes and the 2-3 single
   frames the runner reads itself, the XYZ writer writes each cloud:
   - gray mode on a 30-frame moving-plane dataset, phase lock on, off,
     and on with ``--fast-subpixel``: each locked depth error at the last
     frame must be below 0.05 scene units and below half the
     free-running error; each run's host legs per frame are printed (the
     BMP read by the native pool and by the numpy codec on the same
     files, the npz write and the device-to-host copy). The locked run
     adds ``--save-depth --preview``: depth_iFrame.npz must hold frame
     0's z bit for bit and the calibration's cam_k, the two preview BMPs
     (2 bilateral launches) must be 1024x1280 u8 and the display of the
     kernel path's render, which must be within 1 of the plain chain's
     on at most 0.1% of the pixels; the render's time per call is
     printed;
   - the locked run again with ``--out-format xyz`` (the CLI's default):
     one ``.txt`` per frame, the last frame's lines one per pixel with z
     > 0 and each value within 5e-8 of the locked npz run's maps; its fps
     and writer time per frame are printed;
   - on a 10-frame dataset with the heterodyne fringe stack,
     ``--mode heterodyne`` (lock on): the median depth error of frame 0
     and of the last frame must be below 0.05;
   - on the same dataset, ``--mode spatial``: frame 0 must equal a direct
     ``decode_spatial_frame`` call, be decoded (P != 0) on more than 90%
     of the pixels the projector lights, and have P congruent to the true
     map up to one global period offset on 99% of the decoded interior.
     The multigrid kernels must launch 7 times per preconditioner call
     and ``mg_coarse`` 4 times (the coarsest level's visits),
     ``cg_iters + 1`` calls per decode, ``cg_iters`` taken from a direct
     ``unwrap_spatial(..., return_info=True)`` on the same input. The
     direct decode is then timed through the CG's two CUDA graphs and
     through the eager loop, three calls each in turns after the first
     graph call (the capture), each map bit-equal to the direct one and
     with those launches;
   - the streaming loop (between the gray and the fringe runs):
     ``--chunk 8`` (K steps as one CUDA graph replay) locked and with
     ``--phase-lock off`` on the gray dataset, every cloud bit-identical
     to the ``--chunk 1`` run's, the launch counts those of the per-frame
     run (a replay counts K) and the locked error bars held; the loop's
     fps with ``--no-clouds`` at ``--chunk`` 1, 8 and 16 on a 65-frame
     dataset, with the host wall per frame of ``slc/dynamic_step`` and of
     ``slc/dynamic_chunk`` / K; the writer's
     device-to-host copy per frame, beside a pageable and a pinned copy
     of the same maps timed here; ``streaming.measure_overlap`` at
     1024x1280 (open-loop step, ``compute_repeats="auto"``), printed;
   - ``python -m slc_tpu_torch capture --scene plane --frames 4`` at the
     reference config, then ``run`` on it: frame 0 within 1.0 of z = 50
     on more than 99% of the points; and the golden oracle
     (``slc_tpu_torch.golden``) at 48x64: the open-loop kernel with the
     reference's semantics (P 1e-3, strips exact), ``decode_gray``
     (exact) and ``gray_assisted_merge`` (1e-3) on the card.

6. multi-scan fusion, plain PyTorch on the card but for the
   point-to-plane step's kernels (``csrc/p2l.cu``, port-only):
   ``register_scans`` on 16 scans at 1216x1632 (bench.py's config-5
   frontend) must reach ATE < 0.05 and < 0.25 x the initial ATE, lie
   within 2e-3 of the same call on the CPU, and give the same poses bit
   for bit when the caller has set float32 matmul precision "high"; its
   wall time and its split by stage are printed; the step at sweep16's
   shape (16 views at 1024x1280, grid step 16, normal radius 7: L =
   81,920 landmarks) within 1e-5 of the plain step from the true poses
   and within 1e-5 / 1e-4 (rotations / translations) of the float64
   step from the perturbed ones, its kernels alone in a CUDA graph of 20
   steps beside its bound (one read of obs, mask, landmarks and normals;
   the design's two passes beside it) and the plain step's call and
   kernels; then ``python -m slc_tpu_torch fuse`` through ``main()`` on
   3 depth files at 1024x1280 must meet tests/test_fuse_cli.py's pose
   bar and write a fused.txt of more than two scans' pixels. The timed
   16-scan registration and the CLI's must each be 3 launches of the
   step's kernels a step; their sum is the kernel line's ``launches``;
7. the tile-parallel paths (``slc_tpu_torch.parallel``) on a world-size-1
   NCCL process group and its 1x1x1 mesh at the reference config, each
   run with the launch counts set to 0 just before and read just after:
   ``tiled_absolute_decode`` equal to the plain decode on the card and
   within phase 3's grayphase bars of the kernel; ``tiled_dynamic_step``
   and ``tiled_batched_dynamic_step`` over phase 5's 30-frame gray
   dataset (open loop), P within 1e-4 and z within 1e-3 of the plain
   open-loop step on every frame, and the host wall per frame of the
   three steps and the kernel step, in turns; ``tiled_unwrap_spatial`` on
   the box-step scene of tests/test_unwrap_spatial.py at 1024x1280 and
   1000x1270 against ``unwrap_spatial``: cg_iters within 1, P within
   1e-3 off the zero-quality ring, the diagnostic counts printed side by
   side, its wall; at 1000x1270 its replicated 500x635 level runs
   ``mg_down`` and ``mg_up``, whose counts must be 2 per preconditioner
   call x (cg_iters + 1) (no level kernel at 1024x1280, whose levels stay
   sharded down to 32x40; no kernel on the other tiled paths), and at
   both shapes its replicated coarsest level ``mg_coarse``, 4 per call;
   ``tiled_fuse_scans`` on bench.py's parity problem (16 scans, 128
   landmarks) within 1e-4 of ``fusion.fuse_scans`` at the same damping;
   and ``entry.dryrun_multichip`` with one NCCL rank per card of the host;
8. slc_tpu's scenario tests at the reference config through the step,
   stripe and grayphase kernels, with exact launch counts; every step,
   decode and stripe map held against its plain version from the same
   inputs at phase 3's bars (locked-step tie flips pinned by count):
   a. tests/test_sequence_100.py: 100 frames moving 0.08 a frame,
      stripe period 12, noise 1, rendered one at a time; reference
      semantics, the improved tracker, the locked one (21 x 9) and the
      improved one re-anchored every 25 frames (a grayphase decode and a
      stripe regression at frames 25, 50, 75); the drifts at frames 8
      and 100 must meet the test's orderings and bars;
   b. tests/test_demod_adversarial.py's scenes, cut from 15 frames to
      ADV_FRAMES (0.15 a frame): clean, a non-sinusoidal carrier, the
      lock period x0.95 and x1.05, blur sigma 5 and 12, each locked and
      free; every locked step's per-band carrier-gate decisions from the
      kernel equal to the plain step's, their counts printed; the test's
      locked-against-free envelope on the last frame.

``--no-profiler`` leaves ``torch.profiler`` out of phase 4, as where it
records no CUDA kernel. Any failure ends the script with a non-zero
exit. The last line of its
output is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from slc_tpu_torch import (cloud, devtime, fusion, golden, patterns, runner,
                           se3, streaming, synth, visualization)
from slc_tpu_torch.__main__ import main as slc_main
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import REFERENCE_CONFIG, HeterodyneConfig
from slc_tpu_torch.dynamic import TrackerState, init_tracker, reanchor
from slc_tpu_torch.fusion_frontend import associate_projective, register_scans
from slc_tpu_torch.io import native as native_io
from slc_tpu_torch.io.bmp import _read_bmp_numpy, read_bmp
from slc_tpu_torch.io.dataset import write_replay_dataset
from slc_tpu_torch.io.opencv_yaml import save_calibration
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels import bilateral as kbil
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import floors as kfl
from slc_tpu_torch.kernels import grayphase as kgray
from slc_tpu_torch.kernels import heterodyne as khet
from slc_tpu_torch.kernels import lock_window as klw
from slc_tpu_torch.kernels import mgsmooth as kmg
from slc_tpu_torch.kernels import p2l as kp2l
from slc_tpu_torch.kernels import phaselock as kpl
from slc_tpu_torch.kernels import staging as kstaging
from slc_tpu_torch.kernels import stripe as kstripe
from slc_tpu_torch.ops import unwrap_spatial as U
from slc_tpu_torch.ops import demod
from slc_tpu_torch.ops.demod import GATE_BAND, suggest_lock_window
from slc_tpu_torch.ops.gray import decode_gray
from slc_tpu_torch.ops.phase import decode_phase, modulation
from slc_tpu_torch.ops.unwrap import gray_assisted_merge
from slc_tpu_torch.pipeline import decode_first_frame, decode_spatial_frame

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke_work")
SHAPES = ((1024, 1280), (1000, 1270))
N_FRAMES = 30
#: The loop-rate runs: 64 dynamic frames, four chunks of 16.
N_LOOP_FRAMES = 65
N_CAPTURE_FRAMES = 4
N_FRINGE_FRAMES = 10
LOCK_T = 12.0
HET = HeterodyneConfig()
#: A heterodyne configuration that takes the kernel's generic instance.
HET_GENERIC = HeterodyneConfig(phase_steps=5)
#: Stripe windows held against the plain version: check_window's ends and
#: the reference's 21.
STRIPE_WINDOWS = (5, 21, 63)
#: Phase 8a: tests/test_sequence_100.py's scenario, the reference's 100
#: frames (DYNAFRAME_MAXNUM) of a plane moving 0.08 a frame; the
#: re-anchored run decodes an absolute pattern group every 25 frames.
N_SEQ_FRAMES = 100
SEQ_DZ = 0.08
ANCHOR_EVERY = 25
SEQ_TRACKERS = {
    "reference": dict(scale_gradient=False, subpixel=False, robust=False),
    "improved": {},
    "locked": dict(phase_lock=LOCK_T, lock_win_u=21, lock_win_v=9),
    "anchored": {},
}
#: slc_tpu's own drifts on phase 8a's scene where it misses a bar of
#: tests/test_sequence_100.py at this width (the test set its bars on its
#: 96x160 rig): (tracker, frame) -> (slc_tpu's median |z - z_gt|, the
#: test's bar), from ``JAX_PLATFORMS=cpu python3 tools/reference_drift.py``.
#: There phase 8a holds the kernels to slc_tpu's drift plus the trajectory
#: bar: the open-loop step's z bar 2e-3 per step integrated, after an
#: anchor the decode's 8e-3 plus the steps since.
SLC_TPU_DRIFT = {("improved", 8): (0.1505476379394537, 0.02),
                 ("anchored", 99): (0.3986968231201189, 0.25)}
#: Phase 8b: tests/test_demod_adversarial.py's scenes, 15 frames moving
#: 0.15 a frame there, cut to ADV_FRAMES at the reference width.
ADV_FRAMES = 8
ADV_DZ = 0.15
#: The 16-scan fusion phase at 2 MP (bench.py:44's H2MP x W2MP).
FUSE_SHAPE = (1216, 1632)
FUSE_SCANS = 16

# Bars (tests/test_torch_*.py): decode P 2e-3, x/y/z 8e-3; strips 1e-5;
# locked step and standalone lock P 2e-3, z/x 4e-3; open-loop P 2e-4,
# z 2e-3, x 2e-4; heterodyne P 2e-3, x/y/z 4e-3 off the pinned flips;
# bilateral 1e-4; multigrid levels 2e-6 on O(1) data; floors and the
# coarsest level exact.
BARS = {
    "grayphase": {"proj_u": 2e-3, "x": 8e-3, "y": 8e-3, "z": 8e-3},
    "stripe": {"strip_w": 1e-5, "strip_b": 1e-5},
    "dynamic_step_lock": {"proj_u": 2e-3, "strip_w": 1e-5,
                          "strip_b": 1e-5, "z": 4e-3, "x": 4e-3,
                          "y": 4e-3},
    "dynamic_step": {"proj_u": 2e-4, "strip_w": 1e-5, "strip_b": 1e-5,
                     "z": 2e-3, "x": 2e-4, "y": 2e-4},
    "heterodyne": {"proj_u": 2e-3, "x": 4e-3, "y": 4e-3, "z": 4e-3},
    "bilateral": {"z": 1e-4},
    "mg_down": {"e": 2e-6, "res": 2e-6},
    "mg_up": {"e": 2e-6},
    "mg_coarse": {"e": 0.0},
    "phase_lock": {"proj_u": 2e-3, "z": 4e-3, "x": 4e-3, "y": 4e-3},
    "halo_block_floor": {"o0": 0.0, "o1": 0.0},
}
LOCK_OUT = ("proj_u", "z", "x", "y")
#: Device timing: calls per timed function (devtime's defaults).
TIME_N, TIME_WARMUP = 20, 3
#: suggest_lock_window's host-clock timing: calls per route per turn.
LOCK_ROUTE_CALLS = 5
#: Input sets of the cold step timings: a frame, three carried maps and
#: six outputs each, ~291 MB in all at 1024x1280.
COLD_SETS = 6
#: Bytes each kernel must move per pixel (PERF.md section 3); the floors
#: move those of the kernel whose pattern they read.
BYTES_PER_PX = {"grayphase": 32, "stripe": 9, "dynamic_step_lock": 37,
                "dynamic_step": 37, "heterodyne": 28, "bilateral": 8,
                "mg_down": 24, "mg_up": 24, "phase_lock": 21,
                "floor_stripe": 9, "floor_bilateral": 8}
STEP_OUT = ("proj_u", "strip_w", "strip_b", "z", "x", "y")
#: The locked step's per-pixel arccos refinement takes, of the two
#: readings +-phi, the one nearer the window-corrected prediction
#: (slc_tpu/ops/demod.py:194-201). Where both are equally near, float
#: rounding picks either, and P may move by up to T/2 at that pixel.
#: Such isolated flips are pinned by count per comparison at 1.3 MP, as
#: slc_tpu pins heterodyne beat-order flips (tests/conftest.py:40-61).
LOCK_FLIPS = 32
#: Phase 8's long runs reach the lock's other decisions too (the wrap of
#: the window's phase offset at +-pi, either reading's wrap, the amplitude
#: gate), where P may move by up to one period T; and pixels of low
#: amplitude under bright rows, where the plain version's float32
#: cumulative sums lose the bar's precision. There a P beyond the bar is
#: admitted only where ``lock_ties`` shows such a decision or the kernel
#: within the bar of the float64 demodulation, each within T and at most
#: LOCK_FLIPS per comparison. Likewise a depth that one path clamps to 0
#: at the field of view's edge and the other keeps is admitted only where
#: the kept depth lies within the z bar of that edge (FOV_TIES of them
#: per comparison at most).
FOV_TIES = 32
#: XYZ clouds hold 7 decimals: half a unit of the 7th, plus half an ulp of
#: the float64 the text parses to.
XYZ_BAR = 5e-8 + 1e-12
#: Heterodyne beat-order flips: at most this many per comparison, each
#: exactly one fine fringe order, none in a 2x2 block
#: (tests/conftest.py:40-61).
HET_FLIPS = 8


def require(cond, msg="check failed") -> None:
    """Fail the run (an assert, but kept under ``python -O``)."""
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True)
    return out.stdout.strip()


def compare(name, got, want, keys, errs, flips=0, flip_order=None,
            quiet=False, ties=None, fov=None, period=LOCK_T):
    """Assert each output within its bar; record the max abs error.

    ``flips`` > 0 pins that many isolated branch flips of proj_u (see
    LOCK_FLIPS and HET_FLIPS, proj_u must come first): each may move P by
    at most T/2, or by exactly ``flip_order`` when given; no 2x2 block may
    flip together, and the maps derived from P (z, x, y) are compared on
    the other pixels only. With ``ties`` (a mask of the plain path's tie
    pixels, see FOV_TIES) a flip must lie on a tie and may move P by up
    to one ``period``. With ``fov`` (fov_min, fov_max), up to FOV_TIES pixels whose
    depth one side clamped to 0 and the other keeps within the z bar of
    an edge are left out of z, x and y. ``quiet`` leaves out the line per
    map (phase 8 compares thousands of maps and prints a summary);
    returns the number of flips and clamp ties pinned."""
    agree, pinned = None, 0
    for k, g, e in zip(keys, got, want):
        d = (g - e).abs()
        if k == "z" and fov is not None:
            kept = torch.maximum(g, e)
            edge = (((g == 0) != (e == 0))
                    & (torch.minimum((kept - fov[0]).abs(),
                                     (kept - fov[1]).abs())
                       <= BARS[name]["z"]))
            n_edge = int(edge.sum())
            require(n_edge <= FOV_TIES, f"{name}.z: {n_edge} depths "
                    f"clamped at the field of view's edge on one side only")
            pinned += n_edge
            agree = ~edge if agree is None else agree & ~edge
        if agree is not None and k in ("z", "x", "y"):
            d = torch.where(agree, d, torch.zeros_like(d))
        finite = bool(torch.isfinite(g).all() and torch.isfinite(e).all())
        err = float(d.max())
        bar = BARS[name][k]
        n_over = int((d > bar).sum())
        if not quiet:
            log(f"  {name}.{k}: max|diff| {err:.3e} (bar {bar:g}, "
                f"{n_over} px over)")
        require(finite, f"{name}.{k}: non-finite values")
        # Heterodyne flips are told apart at 1e-2, as conftest does.
        flip = d > (1e-2 if flip_order else bar)
        n_flips = int(flip.sum()) if flips and k == "proj_u" else 0
        if n_flips:
            idx = flip.nonzero().tolist()
            if not quiet:
                log(f"  {name}.proj_u flips at (row, col, kernel, plain): "
                    + ", ".join(f"({r}, {c}, {float(g[r, c]):.4f}, "
                                f"{float(e[r, c]):.4f})"
                                for r, c in idx[:16]))
            block = flip[:-1, :-1] & flip[1:, :-1] & flip[:-1, 1:] \
                & flip[1:, 1:]
            require(n_flips <= flips,
                    f"{name}.proj_u: {n_flips} flips (pinned at {flips})")
            if flip_order:
                orders = d[flip] / flip_order
                require(bool(((orders - 1.0).abs() <= 0.02).all()),
                        f"{name}.proj_u: a flip is not one fine order")
            elif ties is not None:
                require(not bool((flip & ~ties).any()),
                        f"{name}.proj_u: a flip off the plain step's ties")
                require(err <= period + bar,
                        f"{name}.proj_u: a flip moved P by {err} > T")
            else:
                require(err <= LOCK_T / 2 + bar,
                        f"{name}.proj_u: a flip moved P by {err} > T/2")
            require(not bool(block.any()),
                    f"{name}.proj_u: a 2x2 block flipped together")
            agree, pinned = ~flip, pinned + n_flips
            errs[f"{name}_flips"] = errs.get(f"{name}_flips", 0) + n_flips
            d = torch.where(agree, d, torch.zeros_like(d))
            err = float(d.max())
            n_over = int((d > bar).sum())
        require(n_over == 0, f"{name}.{k}: {n_over} px over the bar {bar}")
        errs[name] = max(errs.get(name, 0.0), err)
    return pinned


def host_cpu() -> str:
    """The host CPU's model name, from /proc/cpuinfo."""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def cfg_for(h, w):
    return dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)


def level_chain(h, w, n=3):
    """The first ``n`` multigrid level shapes from (h, w), each side
    halved and rounded up as U.build_mg_levels does: at 1024x1280 the
    three levels the kernels take (min side >= MG_KERNEL_MIN)."""
    shapes = [(h, w)]
    while len(shapes) < n:
        shapes.append((-(-shapes[-1][0] // 2), -(-shapes[-1][1] // 2)))
    return shapes


def mg_level(dev, h, w, seed=0):
    """A random O(1) multigrid level: quality in [0.1, 1]."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(0.1, 1.0, (h, w)).astype(np.float32))
    wy, wx = U.edge_weights(q.to(dev))
    dinv = 1.0 / U._diag(wy, wx)
    r, e = (torch.from_numpy(rng.normal(0, 1, (h, w)).astype(np.float32))
            .to(dev) for _ in range(2))
    return r, e, wy, wx, dinv


def parity(dev, errs, inputs):
    """Phase 3: each kernel against its plain version, on the card."""
    for h, w in SHAPES:
        log(f"parity at {h}x{w}")
        cfg = cfg_for(h, w)
        calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                      pro_w=cfg.pro_w)
        tables = build_tables(calib, h, w, dev)
        scene = synth.render_static_scene(calib, cfg, synth.sphere_surface(),
                                          noise_sigma=1.0)
        g = torch.from_numpy(scene.gray_images).to(dev)
        p = torch.from_numpy(scene.phase_images).to(dev)
        for min_mod in (None, 2.0):
            compare("grayphase",
                    kgray.grayphase_decode_cuda(g, p, tables, cfg, min_mod),
                    kgray.grayphase_decode_ref(g, p, tables, cfg, min_mod),
                    ("x", "y", "z", "proj_u"), errs)
        decoded = kgray.grayphase_decode_cuda(g, p, tables, cfg)[3]
        lock_window_parity(decoded, errs, "decoded frame 0")

        frames, z_gt, pu_gt = synth.render_dynamic_sequence(
            calib, cfg, 2, z0=50.0, dz_per_frame=0.3,
            stripe_period=int(LOCK_T), noise_sigma=1.0)
        rand = np.random.default_rng(0).integers(0, 256, (h, w), np.uint8)
        for frame in (rand, frames[1]):
            f = torch.from_numpy(frame).to(dev)
            for window in STRIPE_WINDOWS:
                for sub, frac in ((True, 0), (False, 0), (True, 7)):
                    compare("stripe",
                            kstripe.stripe_regression_cuda(f, window, sub,
                                                           frac),
                            kstripe.stripe_regression_ref(f, window, sub,
                                                          frac),
                            ("strip_w", "strip_b"), errs)
            floor = kfl.halo_block_floor_cuda(f, 21 // 2, 2)
            compare("halo_block_floor", floor,
                    kfl.halo_block_floor_ref(f, 21 // 2, 2), ("o0", "o1"),
                    errs)

        f0 = torch.from_numpy(frames[0]).to(dev)
        f1 = torch.from_numpy(frames[1]).to(dev)
        pu0 = torch.from_numpy(pu_gt[0].astype(np.float32)).to(dev)
        sw0, sb0 = kstripe.stripe_regression_ref(f0, cfg.reco_window, True)
        win = suggest_lock_window(pu_gt[0], LOCK_T)
        log(f"  suggested lock window {win}")
        lock_window_parity(pu0, errs, "true map, float32")
        args = (f1, sw0, sb0, pu0, tables)
        for ref, frac in ((False, 0), (True, 0), (False, 7)):
            kw = dict(window=cfg.reco_window, subpixel=not ref,
                      scale_gradient=not ref, robust=not ref,
                      fov_min=cfg.fov_min, fov_max=cfg.fov_max,
                      frac_bits=frac)
            opened = kstep.dynamic_step_open_cuda(*args, **kw)
            if not ref and not frac:
                p_open = opened[0]
            compare("dynamic_step", opened,
                    kstep.dynamic_step_open_ref(*args, **kw), STEP_OUT, errs)
            for win_u in sorted({21, win}):
                lk = dict(kw, period=LOCK_T, win_u=win_u, win_v=9)
                fused = kstep.dynamic_step_lock_cuda(*args, **lk)
                compare("dynamic_step_lock", fused,
                        kstep.dynamic_step_lock_ref(*args, **lk), STEP_OUT,
                        errs, flips=LOCK_FLIPS)
                # The two-kernel form: the standalone lock on the
                # open-loop step's P runs the same launches.
                lock = kpl.phase_lock_cuda(
                    f1, opened[0], tables, period=LOCK_T, win_u=win_u,
                    win_v=9, fov_min=cfg.fov_min, fov_max=cfg.fov_max)
                two = lock[:1] + opened[1:3] + lock[1:]
                same = all(torch.equal(a, b) for a, b in zip(two, fused))
                log(f"  two-kernel vs fused locked step (frac_bits {frac}, "
                    f"win_u {win_u}): {'bit-identical' if same else 'DIFFER'}")
                require(same, "the two-kernel locked step differs from the "
                              "fused one")

        # The standalone lock on the open-loop step's P, as in the
        # two-kernel step, with a hole band cut in (tests/test_pallas.py:
        # 311), which must stay a hole.
        pred = p_open.clone()
        pred[:, 40:48] = 0.0
        keep = pred.clone()
        for win_u in sorted({21, win}):
            pk = dict(period=LOCK_T, win_u=win_u, win_v=9,
                      fov_min=cfg.fov_min, fov_max=cfg.fov_max)
            got = kpl.phase_lock_cuda(f1, pred, tables, **pk)
            require(torch.equal(pred, keep), "phase_lock changed its input")
            require(bool((got[0][:, 42:46] == 0).all()),
                    "phase_lock corrected the hole band")
            compare("phase_lock", got, kpl.phase_lock_ref(f1, pred, tables,
                                                          **pk),
                    LOCK_OUT, errs, flips=LOCK_FLIPS)

        for het in (HET_GENERIC, HET):
            fringes, _, _ = synth.render_fringe_stack(
                calib, cfg, synth.sphere_surface(), het.periods(cfg.pro_w),
                het.phase_steps, noise_sigma=1.0)
            fr = torch.from_numpy(fringes).to(dev)
            fine = het.periods(cfg.pro_w)[0]
            log(f"  heterodyne {len(het.fringe_counts)} frequencies x "
                f"{het.phase_steps} steps")
            for min_mod in (None, 2.0):
                got = khet.heterodyne_decode_cuda(fr, tables, cfg, het,
                                                  min_mod)
                want = khet.heterodyne_decode_ref(fr, tables, cfg, het,
                                                  min_mod)
                compare("heterodyne", got[3:] + got[:3],
                        want[3:] + want[:3], ("proj_u", "x", "y", "z"),
                        errs, flips=HET_FLIPS, flip_order=fine)

        # A rendered depth map (the heterodyne decode's) with 5% holes.
        depth = want[2].clone()
        holes = np.random.default_rng(1).uniform(size=(h, w)) < 0.05
        depth[torch.from_numpy(holes).to(dev)] = 0.0
        compare("bilateral", (kbil.bilateral_filter_cuda(depth),),
                (kbil.bilateral_filter_ref(depth),), ("z",), errs)
        compare("halo_block_floor", kfl.halo_block_floor_cuda(depth, 1, 1),
                kfl.halo_block_floor_ref(depth, 1, 1), ("o0",), errs)

        levels = {}
        for lh, lw in level_chain(h, w):
            r, e, wy, wx, dinv = levels[(lh, lw)] = mg_level(dev, lh, lw)
            log(f"  multigrid level {lh}x{lw}")
            compare("mg_down", kmg.mg_down_cuda(r, wy, wx, dinv),
                    kmg.mg_down_ref(r, wy, wx, dinv), ("e", "res"), errs)
            compare("mg_up", (kmg.mg_up_cuda(e, r, wy, wx, dinv),),
                    (kmg.mg_up_ref(e, r, wy, wx, dinv),), ("e",), errs)
        ch, cw = mg_shapes(h, w)[-1]
        coarse = mg_level(dev, ch, cw)
        log(f"  coarsest multigrid level {ch}x{cw}")
        cr, _, cwy, cwx, cdinv = coarse
        compare("mg_coarse", (kmg.mg_coarse_cuda(cr, cwy, cwx, cdinv),),
                (kmg.mg_coarse_ref(cr, cwy, cwx, cdinv),), ("e",), errs)
        if (h, w) == SHAPES[0]:
            inputs.update(g=g, p=p, tables=tables, cfg=cfg, frame=f1,
                          step_args=args, win=win, fringes=fr, depth=depth,
                          level=levels[(h, w)], levels=levels, pred=pred,
                          lock_pu=decoded, coarse=coarse)


def lock_window_parity(pu, errs, what):
    """The lock window's kernel on the card map ``pu`` against its plain
    version: n and the two middle values exactly, and the window that
    ``suggest_lock_window`` takes from them equal to the host path's (the
    same map as a CPU tensor, through numpy)."""
    got = klw.middle_abs_gradients(pu)
    host = pu.cpu()
    want = klw.middle_abs_gradients_ref(host.numpy())
    require(got == want, f"lock window, {what}: kernel (n, lo, hi) {got} "
                         f"!= plain {want}")
    win, host_win = (suggest_lock_window(x, LOCK_T) for x in (pu, host))
    require(win == host_win, f"lock window, {what}: {win} on the card, "
                             f"{host_win} on the host")
    errs["lock_window"] = max(errs.get("lock_window", 0.0),
                              abs(got[1] - want[1]), abs(got[2] - want[2]))
    log(f"  lock window, {what}: n {got[0]}, middle |g| {got[1]!r}, "
        f"{got[2]!r} (kernel == plain, exact); window {win} on the card "
        f"== {host_win} on the host")


def timing(inputs, card, use_profiler=True):
    """Phase 4, the device-timing path at 1024x1280. Two device times
    per function: the call (CUDA events around it, so the host's gaps
    between its launches count: the wrappers' Python and ctypes time
    shows in a short kernel's call) and its kernels alone (a kernel's
    calls captured in a CUDA graph and replayed; a plain version's from
    the profiler's records, None where the profiler records no CUDA
    kernel). Returns {name: (kernel call ms, plain call ms, kernel device
    ms, plain device ms)} and the launch count each kernel must show
    (every call of a wrapper launches it once, a captured one too; graph
    replays call no wrapper)."""
    g, p, tables, cfg = (inputs[k] for k in ("g", "p", "tables", "cfg"))
    args, frame, pred = inputs["step_args"], inputs["frame"], inputs["pred"]
    fr, depth = inputs["fringes"], inputs["depth"]
    r, e, wy, wx, dinv = inputs["level"]
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    lk = dict(kw, period=LOCK_T, win_u=inputs["win"], win_v=9)
    pk = dict(period=LOCK_T, win_u=inputs["win"], win_v=9,
              fov_min=cfg.fov_min, fov_max=cfg.fov_max)
    halo = cfg.reco_window // 2
    expect = {k: 0 for k in WRAPPERS}
    prof = {"on": use_profiler and devtime.profiler_sees_cuda()}
    log("torch.profiler records CUDA kernels: "
        + ("yes" if prof["on"] else "not used" if not use_profiler else
           "no (CUPTI tracing is not available to this process)")
        + ("" if prof["on"] else ": the plain versions' kernels alone and "
           "the locked step by launch are not measured"))

    def dev_ms(fn, *kernels, match=None):
        """CUDA events around each call, or with ``match`` the profiler's
        kernel records (None, and the profiler left out from then on, if
        it is off or a session records no CUDA kernel)."""
        if match is not None and not prof["on"]:
            return None
        for k in kernels:
            expect[k] += TIME_WARMUP + TIME_N
        try:
            return 1e3 * devtime.device_time_s(fn, TIME_N, match,
                                               TIME_WARMUP)
        except devtime.ProfilerUnavailable as e:
            log(f"torch.profiler: {e}; not used from here on")
            prof["on"] = False
            return None

    def alone_ms(fn, *kernels):
        """The kernels alone: 20 calls in one CUDA graph, replayed."""
        for k in kernels:
            expect[k] += TIME_WARMUP + TIME_N
        return 1e3 * devtime.graph_time_s(fn, TIME_N, TIME_WARMUP)

    def two_kernel_step(frac=0):
        opened = kstep.dynamic_step_open_cuda(*args, **kw, frac_bits=frac)
        return kpl.phase_lock_cuda(frame, opened[0], tables, **pk)

    pairs = {
        "grayphase": (
            lambda: kgray.grayphase_decode_cuda(g, p, tables, cfg),
            lambda: kgray.grayphase_decode_ref(g, p, tables, cfg)),
        "stripe": (
            lambda: kstripe.stripe_regression_cuda(frame, 21),
            lambda: kstripe.stripe_regression_ref(frame, 21)),
        "dynamic_step_lock": (
            lambda: kstep.dynamic_step_lock_cuda(*args, **lk),
            lambda: kstep.dynamic_step_lock_ref(*args, **lk)),
        "dynamic_step": (
            lambda: kstep.dynamic_step_open_cuda(*args, **kw),
            lambda: kstep.dynamic_step_open_ref(*args, **kw)),
        "heterodyne": (
            lambda: khet.heterodyne_decode_cuda(fr, tables, cfg, HET),
            lambda: khet.heterodyne_decode_ref(fr, tables, cfg, HET)),
        "bilateral": (lambda: kbil.bilateral_filter_cuda(depth),
                      lambda: kbil.bilateral_filter_ref(depth)),
        "mg_down": (lambda: kmg.mg_down_cuda(r, wy, wx, dinv),
                    lambda: kmg.mg_down_ref(r, wy, wx, dinv)),
        "mg_up": (lambda: kmg.mg_up_cuda(e, r, wy, wx, dinv),
                  lambda: kmg.mg_up_ref(e, r, wy, wx, dinv)),
        "phase_lock": (lambda: kpl.phase_lock_cuda(frame, pred, tables,
                                                   **pk),
                       lambda: kpl.phase_lock_ref(frame, pred, tables,
                                                  **pk)),
        "floor_stripe": (
            lambda: kfl.halo_block_floor_cuda(frame, halo, 2),
            lambda: kfl.halo_block_floor_ref(frame, halo, 2)),
        "floor_bilateral": (
            lambda: kfl.halo_block_floor_cuda(depth, 1, 1),
            lambda: kfl.halo_block_floor_ref(depth, 1, 1)),
    }
    wrapper_of = {"floor_stripe": "halo_block_floor",
                  "floor_bilateral": "halo_block_floor"}
    out, ops = {}, {}
    for name, (kern, plain) in pairs.items():
        ops[name] = devtime.count_ops(plain)
        # plain, kernel, kernel, plain: the mean of each side's two.
        wrapper = wrapper_of.get(name, name)
        t_p1 = dev_ms(plain)
        t_k1 = dev_ms(kern, wrapper)
        t_k2 = dev_ms(kern, wrapper)
        t_p2 = dev_ms(plain)
        k_dev = alone_ms(kern, wrapper)
        line = (f"time {name} at 1024x1280: call kernel "
                f"{(t_k1 + t_k2) / 2:.4f} ms ({t_k1:.4f}, {t_k2:.4f}), "
                f"plain {(t_p1 + t_p2) / 2:.4f} ms ({t_p1:.4f}, "
                f"{t_p2:.4f}); kernels alone: kernel {k_dev:.4f} ms "
                f"(graph)")
        k_prof = dev_ms(kern, wrapper, match="")
        p_dev = dev_ms(plain, match="")
        line += (f", {fmt_ms(k_prof)} (profiler); plain {fmt_ms(p_dev)} "
                 f"(profiler)")
        out[name] = ((t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2, k_dev, p_dev)
        log(line)

    # The one PyTorch call that computes a kernel's function, where there
    # is one: the floors' o_k = float(img) + k as one broadcast add.
    library = {}
    for name, img, n_out in (("floor_stripe", frame, 2),
                             ("floor_bilateral", depth, 1)):
        k = torch.arange(n_out, dtype=torch.float32,
                         device=img.device)[:, None, None]
        want = torch.stack(pairs[name][1]())
        require(torch.equal(img + k, want),
                f"{name}: the library call differs from the plain version")
        call = dev_ms(lambda: img + k)
        alone = alone_ms(lambda: img + k)
        library[name] = call
        log(f"time {name} library call (img + arange(n_out)[:, None, None]) "
            f"at 1024x1280: call {call:.4f} ms, kernels alone {alone:.4f} ms "
            f"(graph); the kernel's {out[name][0]:.4f} / {out[name][2]:.4f} "
            f"ms")

    # Fast sub-pixel mode vs exact, and the two-kernel vs the fused
    # locked step, in turns (exact, fast, fast, exact), kernels alone.
    variants = {
        "stripe": (lambda f: (lambda: kstripe.stripe_regression_cuda(
            frame, 21, True, f)), ("stripe",)),
        "dynamic_step": (lambda f: (lambda: kstep.dynamic_step_open_cuda(
            *args, **kw, frac_bits=f)), ("dynamic_step",)),
        "dynamic_step_lock": (lambda f: (
            lambda: kstep.dynamic_step_lock_cuda(*args, **lk, frac_bits=f)),
            ("dynamic_step_lock",)),
        "two_kernel_locked_step": (lambda f: (lambda: two_kernel_step(f)),
                                   ("dynamic_step", "phase_lock")),
    }
    for name, (make, kernels) in variants.items():
        t = [alone_ms(make(f), *kernels) for f in (0, 7, 7, 0)]
        log(f"time {name} at 1024x1280, frac_bits 7 vs 0: "
            f"{(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, {t[2]:.4f}) vs "
            f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f})")
    def fused_step():
        return kstep.dynamic_step_lock_cuda(*args, **lk)

    fused = [f(fused_step, "dynamic_step_lock") for f in (dev_ms, alone_ms)]
    two = [f(two_kernel_step, "dynamic_step", "phase_lock")
           for f in (dev_ms, alone_ms)]
    scratch = kstep.lock_buffers(cfg.cam_h, cfg.cam_w, inputs["win"], 9,
                                 frame.device)[0]
    log(f"lock scratch at 1024x1280: {scratch.numel() * 4} bytes (DC, the "
        f"correction map and the gate partials)")
    log(f"time locked step at 1024x1280, call / kernels alone: fused "
        f"{fused[0]:.4f} / {fused[1]:.4f} ms, two-kernel (open-loop step "
        f"+ phase_lock) {two[0]:.4f} / {two[1]:.4f} ms")

    # The locked step by stage (cumulative: the launches stop after the
    # stage) and, where the profiler records kernels, by launch.
    stages = {label: alone_ms(lambda: kstep.dynamic_step_lock_cuda(
        *args, **lk, ablate=ab), "dynamic_step_lock")
        for ab, label in (("track", "track"), ("dc", "+ DC"),
                          ("corr", "+ C/S and correction"), ("", "all"))}
    log("locked step stages, cumulative device ms (graph): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))

    # The steps cold: every call reads its inputs and writes its outputs
    # in device memory, as a stream of frames does, not in L2.
    sets = [tuple(a.clone() for a in args[:4]) + (tables,)
            for _ in range(COLD_SETS)]
    for name, step in (
            ("dynamic_step", lambda a: kstep.dynamic_step_open_cuda(*a, **kw)),
            ("dynamic_step_lock",
             lambda a: kstep.dynamic_step_lock_cuda(*a, **lk))):
        cold = alone_ms(devtime.rotating(step, sets), name)
        log(f"time {name} at 1024x1280, kernels alone (graph): L2-resident "
            f"{out[name][2]:.4f} ms, cold {cold:.4f} ms (inputs and outputs "
            f"rotated over {COLD_SETS} sets)")
    del sets

    # Heterodyne cold: its 12 planes and 4 maps, 36.7 MB a set.
    sets = [fr.clone() for _ in range(COLD_SETS)]
    cold = alone_ms(devtime.rotating(
        lambda a: khet.heterodyne_decode_cuda(a, tables, cfg, HET), sets),
        "heterodyne")
    del sets
    log(f"time heterodyne at 1024x1280, kernels alone (graph): L2-resident "
        f"{out['heterodyne'][2]:.4f} ms, cold {cold:.4f} ms (inputs and "
        f"outputs rotated over {COLD_SETS} sets)")

    # Bilateral cold: one f32 map in and one out, 10.5 MB a set.
    sets = [depth.clone() for _ in range(COLD_SETS)]
    cold = alone_ms(devtime.rotating(kbil.bilateral_filter_cuda, sets),
                    "bilateral")
    del sets
    log(f"time bilateral at 1024x1280, kernels alone (graph): L2-resident "
        f"{out['bilateral'][2]:.4f} ms, cold {cold:.4f} ms (inputs and "
        f"outputs rotated over {COLD_SETS} sets)")

    # The multigrid kernels at each level shape of the reference chain
    # (kernels alone), both also cold at full size, and each kernel's
    # time per preconditioner call: launches per level x time.
    level_ms = {}
    for (lh, lw), (lr, le, lwy, lwx, ldinv) in inputs["levels"].items():
        level_ms[(lh, lw)] = {
            "mg_down": alone_ms(lambda: kmg.mg_down_cuda(lr, lwy, lwx, ldinv),
                                "mg_down"),
            "mg_up": alone_ms(lambda: kmg.mg_up_cuda(le, lr, lwy, lwx,
                                                     ldinv), "mg_up")}
        log(f"time multigrid level {lh}x{lw}, kernels alone (graph): "
            + ", ".join(f"{k} {v:.4f} ms"
                        for k, v in level_ms[(lh, lw)].items()))
    sets = [tuple(a.clone() for a in (e, r, wy, wx, dinv))
            for _ in range(COLD_SETS)]
    cold = {"mg_down": alone_ms(devtime.rotating(
                lambda a: kmg.mg_down_cuda(*a[1:]), sets), "mg_down"),
            "mg_up": alone_ms(devtime.rotating(
                lambda a: kmg.mg_up_cuda(*a), sets), "mg_up")}
    del sets
    for k, v in cold.items():
        log(f"time {k} at 1024x1280, kernels alone (graph): L2-resident "
            f"{level_ms[SHAPES[0]][k]:.4f} ms, cold {v:.4f} ms (inputs and "
            f"outputs rotated over {COLD_SETS} sets)")
    visits = mg_kernel_visits(*SHAPES[0])
    log("multigrid kernels per preconditioner call at 1024x1280 (launches "
        "per level x kernels-alone time): " + "; ".join(
            f"{k} " + " + ".join(f"{n} x {level_ms[sh][k]:.4f}"
                                 for sh, n in visits.items())
            + f" = {mg_ms_per_call(level_ms, k):.4f} ms"
            for k in ("mg_down", "mg_up")))
    launches = {k: dev_ms(fused_step, "dynamic_step_lock", match=k)
                for k in ("track_kernel", "lock_dc_kernel",
                          "lock_corr_kernel", "snap_kernel")}
    log("locked step launches, device ms per step (profiler): "
        + ", ".join(f"{k} {fmt_ms(v)}" for k, v in launches.items())
        + (f" (sum {sum(launches.values()):.4f} ms)"
           if None not in launches.values() else ""))

    # Rooflines: bytes the kernel must move over its kernels' device
    # time; and each kernel's bound, the larger of its bytes over the
    # memory rate and its plain version's operations (devtime.count_ops)
    # over the float32 rate; none for a card whose peaks are not listed.
    px = cfg.cam_h * cfg.cam_w
    name0 = torch.cuda.get_device_name(0)
    peak = devtime.HBM_PEAK_GBPS.get(name0)
    f32 = devtime.F32_PEAK_TFLOPS.get(name0)
    log(f"rooflines at 1024x1280 on {card}, published peaks: HBM "
        + (f"{peak:g} GB/s" if peak else "not in the table") + ", float32 "
        + (f"{f32:g} TFLOP/s" if f32 else "not in the table"))
    floor_of = {"stripe": "floor_stripe", "bilateral": "floor_bilateral"}
    bounds = {}
    for name, (_, _, ms, _) in out.items():
        bpp = BYTES_PER_PX[name]
        gbs = bpp * px / (ms * 1e-3) / 1e9
        line = (f"roofline {name}: {ms:.4f} ms, {bpp} B/px, "
                f"{gbs:.1f} GB/s")
        if peak:
            line += f", {100.0 * gbs / peak:.1f}% of HBM peak"
        if name in floor_of:
            fl = out[floor_of[name]][2]
            line += (f", {100.0 * fl / ms:.1f}% of the measured floor "
                     f"({fl:.4f} ms)")
        line += f"; {ops[name] / px:.1f} operations/px"
        if peak and f32:
            by = {"bytes": 1e3 * bpp * px / (peak * 1e9),
                  "operations": 1e3 * ops[name] / (f32 * 1e12)}
            bound_by = max(by, key=by.get)
            bounds[name] = (by[bound_by], bound_by)
            line += (f"; bound {by[bound_by]:.4f} ms by {bound_by} (bytes "
                     f"{by['bytes']:.4f} ms, operations "
                     f"{by['operations']:.4f} ms)")
        else:
            bounds[name] = (None, None)
            line += "; bound not known for this card"
        log(line)

    # The lock window's median (port-only, csrc/lock_window.cu) on the
    # decoded frame-0 map: the kernel's call and its launches alone on the
    # device; then suggest_lock_window's routes by the host clock, in
    # turns: a card tensor, a float32 host map (uploaded first, as the
    # benchmark's harness hands it over) and a CPU tensor (numpy, the
    # host path). Its plain time is the numpy route's; its bound one read
    # of the map from memory.
    pu = inputs["lock_pu"]
    host = pu.cpu()
    kern = lambda: klw.middle_abs_gradients_cuda(pu)  # noqa: E731
    t_k = [dev_ms(kern, "lock_window") for _ in range(2)]
    k_dev = alone_ms(kern, "lock_window")
    routes = {"card tensor": pu, "float32 host map": host.numpy(),
              "CPU tensor (numpy)": host}
    host_ms = {k: [] for k in routes}
    for r in range(4):
        for k in (list(routes) if r % 2 == 0 else list(routes)[::-1]):
            for _ in range(LOCK_ROUTE_CALLS):
                t0 = time.perf_counter()
                suggest_lock_window(routes[k], LOCK_T)
                host_ms[k].append(1e3 * (time.perf_counter() - t0))
            if k != "CPU tensor (numpy)":
                expect["lock_window"] += LOCK_ROUTE_CALLS
    med = {k: statistics.median(v) for k, v in host_ms.items()}
    out["lock_window"] = ((t_k[0] + t_k[1]) / 2, med["CPU tensor (numpy)"],
                          k_dev, None)
    log(f"time lock_window at 1024x1280: call kernel "
        f"{(t_k[0] + t_k[1]) / 2:.4f} ms ({t_k[0]:.4f}, {t_k[1]:.4f}); "
        f"kernels alone {k_dev:.4f} ms (graph)")
    log(f"time suggest_lock_window at 1024x1280 on {card}, host clock, "
        f"median of {4 * LOCK_ROUTE_CALLS} calls in turns: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items()))
    gbs = 4 * px / (k_dev * 1e-3) / 1e9
    line = (f"roofline lock_window: {k_dev:.4f} ms, 4 B/px (one read of "
            f"the map; its passes after the first read it from L2), "
            f"{gbs:.1f} GB/s")
    if peak:
        bounds["lock_window"] = (1e3 * 4 * px / (peak * 1e9), "bytes")
        line += (f", {100.0 * gbs / peak:.1f}% of HBM peak; bound "
                 f"{bounds['lock_window'][0]:.4f} ms by bytes")
    else:
        bounds["lock_window"] = (None, None)
        line += "; bound not known for this card"
    log(line)

    # The coarsest level (port-only: mg_coarse in csrc/mgsmooth.cu) at
    # 1024x1280's 32x40: the kernel's call and its launch alone, also at
    # one sweep (its staging, write-back and launch), against the plain
    # visit's, whose 467 launches a graph of 20 visits replays. Its bound
    # is latency, 32 dependent block-wide sweeps; its ~30 KB of traffic
    # and ~0.5 MFLOP would take ~0.01 ms.
    cr, _, cwy, cwx, cdinv = inputs["coarse"]
    ch, cw = cr.shape
    kern = lambda: kmg.mg_coarse_cuda(cr, cwy, cwx, cdinv)  # noqa: E731
    plain = lambda: kmg.mg_coarse_ref(cr, cwy, cwx, cdinv)  # noqa: E731
    t_p1 = dev_ms(plain)
    t_k = [dev_ms(kern, "mg_coarse") for _ in range(2)]
    t_p2 = dev_ms(plain)
    k_dev = alone_ms(kern, "mg_coarse")
    k_one = alone_ms(lambda: kmg.mg_coarse_cuda(cr, cwy, cwx, cdinv,
                                                U.MG_OMEGA, 1), "mg_coarse")
    p_dev = alone_ms(plain)
    out["mg_coarse"] = ((t_k[0] + t_k[1]) / 2, (t_p1 + t_p2) / 2, k_dev,
                        p_dev)
    bounds["mg_coarse"] = (None, "latency")
    per_sweep = 1e3 * (k_dev - k_one) / (U.MG_COARSE_SWEEPS - 1)
    log(f"time mg_coarse at {ch}x{cw} ({U.MG_COARSE_SWEEPS} sweeps): call "
        f"kernel {(t_k[0] + t_k[1]) / 2:.4f} ms ({t_k[0]:.4f}, "
        f"{t_k[1]:.4f}), plain {(t_p1 + t_p2) / 2:.4f} ms ({t_p1:.4f}, "
        f"{t_p2:.4f}); kernels alone (graph): kernel {k_dev:.4f} ms, at "
        f"1 sweep {k_one:.4f} ms, so {per_sweep:.3f} us a sweep; the "
        f"plain visit {p_dev:.4f} ms; bound: latency")
    return out, expect, bounds, library, level_ms


#: The kernel wrappers, each with its ``launches`` count.
WRAPPERS = {"grayphase": kgray.grayphase_decode_cuda,
            "stripe": kstripe.stripe_regression_cuda,
            "dynamic_step_lock": kstep.dynamic_step_lock_cuda,
            "dynamic_step": kstep.dynamic_step_open_cuda,
            "heterodyne": khet.heterodyne_decode_cuda,
            "bilateral": kbil.bilateral_filter_cuda,
            "mg_down": kmg.mg_down_cuda,
            "mg_up": kmg.mg_up_cuda,
            "mg_coarse": kmg.mg_coarse_cuda,
            "phase_lock": kpl.phase_lock_cuda,
            "halo_block_floor": kfl.halo_block_floor_cuda,
            "lock_window": klw.middle_abs_gradients_cuda}


def reset_counts():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_counts():
    return {k: w.launches for k, w in WRAPPERS.items()}


def counted_run(argv, expected_fn, io_expected, out_format="npz"):
    """One ``main(["run", ...])`` with every launch count and every
    native I/O counter set to 0 just before it and read just after; the
    launch counts must equal ``expected_fn()`` (evaluated after the run)
    and the native counters ``io_expected`` exactly; and every frame the
    pool delivers must go to the card through the frame stager's staging
    entry (``kernels.staging.stage_h2d``), one call a frame."""
    reset_counts()
    native_io.reset_counts()
    kstaging.stage_h2d.launches = 0
    rc = slc_main(["run", *argv, "--out-format", out_format, "--device",
                   "cuda"])
    got = read_counts()
    io_got = dict(native_io.COUNTS)
    staged = kstaging.stage_h2d.launches
    require(rc == 0, f"run {argv} exited {rc}")
    require(staged == io_expected["loader_frames"],
            f"{staged} staged frames, {io_expected['loader_frames']} read")
    want = {k: 0 for k in WRAPPERS}
    want.update(expected_fn())
    log(f"e2e launches {got}")
    require(got == want, f"launch counts {got} != expected {want}")
    io_want = {k: 0 for k in native_io.COUNTS}
    io_want.update(io_expected)
    log(f"e2e native I/O {io_got}")
    require(io_got == io_want, f"native I/O counts {io_got} != expected "
                               f"{io_want}")
    return got


def native_expected(planes, n_frames, lock=True, xyz=False, previews=0):
    """The native I/O counts of one run: the pool delivers every dynamic
    frame after frame 0; the codec reads frame 0's ``planes``, the period
    diagnostic's frame 0 (lock on), the tracker's frame 0 and the warm-up
    step's frame 1, and writes the ``previews``; the XYZ writer writes
    each of the ``n_frames`` clouds."""
    return {"loader_frames": n_frames - 1,
            "bmp_reads": planes + int(lock) + 2,
            "bmp_writes": previews,
            "xyz_writes": n_frames if xyz else 0}


def run_records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def frame_records(out):
    return [x for x in run_records(out) if "frame" in x]


def host_legs(out, ds, h, w):
    """A run's host legs, ms per frame: the device-to-host copy and the
    write of each cloud from its writer summary; and the BMP read of the
    same dynamic frames (page cache warm), timed here after the run, by
    the native pool as the runner makes it (8 slots, 4 threads) and by the
    numpy codec, one file after another."""
    summary = next(r for r in run_records(out) if r.get("writer"))
    n = summary["writer_frames"]
    copy = summary["writer_copy_ms"] / n
    write = (summary["writer_total_ms"] - summary["writer_copy_ms"]) / n
    paths = [os.path.join(ds, "cFrame", f"dynaCam{i}.bmp")
             for i in range(1, N_FRAMES)]
    t0 = time.perf_counter()
    for _ in native_io.NativeFrameLoader(paths, h, w, slots=8, threads=4):
        pass
    pool = 1e3 * (time.perf_counter() - t0) / len(paths)
    t0 = time.perf_counter()
    for path in paths:
        _read_bmp_numpy(path)
    numpy_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    return {"read_pool": pool, "read_numpy": numpy_ms, "copy": copy,
            "write": write}


def median_err(z, z_gt, margin, min_valid=0.9):
    zi, gi = z[margin:-margin, margin:-margin], z_gt[margin:-margin,
                                                     margin:-margin]
    v = zi > 0
    require(np.isfinite(z).all() and v.mean() > min_valid,
            f"depth not finite or mostly invalid ({v.mean():.4f} valid)")
    return float(np.median(np.abs(zi[v] - gi[v])))


def gray_runs(launches):
    """Phase 5a: the gray replay path through the CLI, lock on and off,
    and lock on in fast sub-pixel mode."""
    cfg = REFERENCE_CONFIG
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    t0 = time.perf_counter()
    scene = synth.render_static_scene(calib, cfg, synth.plane_surface(50.0),
                                      noise_sigma=1.0)
    frames, zs, _ = synth.render_dynamic_sequence(
        calib, cfg, N_FRAMES, z0=50.0, dz_per_frame=0.3,
        stripe_period=int(LOCK_T), noise_sigma=1.0)
    ds = os.path.join(WORK, "ds")
    write_replay_dataset(ds, scene.gray_images, scene.phase_images, frames,
                         config_fields={"pro_h": cfg.pro_h,
                                        "pro_w": cfg.pro_w,
                                        "gray_bits": cfg.gray_bits,
                                        "phase_steps": cfg.phase_steps,
                                        "stripe_period": int(LOCK_T)})
    save_calibration(os.path.join(ds, "parameters.yml"), calib)
    log(f"e2e gray: rendered and wrote {N_FRAMES} frames at "
        f"{cfg.cam_h}x{cfg.cam_w} in {time.perf_counter() - t0:.1f} s")

    # Per run the runner decodes frame 0 twice (a warm-up, then the
    # timed decode), tracks frame 0 once (init_tracker) and steps once
    # for its warm-up plus once per remaining frame.
    errs = {}
    planes = 2 * cfg.gray_bits + cfg.phase_steps
    calib_path = os.path.join(ds, "parameters.yml")
    # The locked run also writes frame 0's depth for ``fuse`` and the two
    # previews, each rendered through the bilateral kernel.
    for name, extra, step in (
            ("locked", ["--save-depth", "--preview"], "dynamic_step_lock"),
            ("free", ["--phase-lock", "off"], "dynamic_step"),
            ("fast", ["--fast-subpixel"], "dynamic_step_lock")):
        out = os.path.join(WORK, name)
        previews = 2 if name == "locked" else 0
        got = counted_run(
            [ds, "--calib", calib_path, "--out", out, *extra],
            lambda: {"grayphase": 2, "stripe": 1, step: N_FRAMES,
                     "bilateral": previews,
                     "lock_window": int(step == "dynamic_step_lock")},
            native_expected(planes, N_FRAMES, lock=name != "free",
                            previews=previews))
        for k, v in got.items():
            launches[k] += v
        if previews:
            check_depth_and_previews(out, calib)
        z = np.load(os.path.join(out, f"cFrame{N_FRAMES - 1}.npz"))["z"]
        errs[name] = median_err(z, zs[N_FRAMES - 1], cfg.reco_window // 2 + 2)
        recs = frame_records(out)
        require(len(recs) == N_FRAMES, f"{name}: {len(recs)} records")
        steps = [x["t_dynamic_step_ms"] for x in recs[1:]]
        fps = [x["fps"] for x in recs[2:]]
        log(f"e2e gray {name}: median|z err| at frame {N_FRAMES - 1} "
            f"{errs[name]:.5f}, valid_frac {recs[-1]['valid_frac']:.4f}, "
            f"step median {statistics.median(steps):.3f} ms, "
            f"fps median {statistics.median(fps):.1f}, "
            f"decode {recs[0]['t_first_frame_ms']:.3f} ms")
        legs = host_legs(out, ds, cfg.cam_h, cfg.cam_w)
        log(f"e2e gray {name} host legs, ms per frame (host CPU "
            f"{host_cpu()}): BMP read {legs['read_pool']:.3f} by the native "
            f"pool, {legs['read_numpy']:.3f} by the numpy codec (the same "
            f"{N_FRAMES - 1} files, after the run); npz write "
            f"{legs['write']:.3f}; device-to-host copy {legs['copy']:.3f} "
            f"(the run's writer thread)")
    for name in ("locked", "fast"):
        require(errs[name] < 0.05, f"{name} error too large: {errs}")
        require(errs[name] < 0.5 * errs["free"],
                f"{name} error not below half the free-running one: {errs}")

    # The CLI's default output, XYZ clouds through the native writer, on
    # the locked run's dataset; its last cloud against the locked npz
    # run's maps (the same inputs through the same kernels give the same
    # maps).
    out = os.path.join(WORK, "xyz")
    got = counted_run([ds, "--calib", calib_path, "--out", out],
                      lambda: {"grayphase": 2, "stripe": 1,
                               "dynamic_step_lock": N_FRAMES,
                               "lock_window": 1},
                      native_expected(planes, N_FRAMES, xyz=True),
                      out_format="xyz")
    for k, v in got.items():
        launches[k] += v
    clouds = sorted(f for f in os.listdir(out) if f.endswith(".txt"))
    require(clouds == sorted(["iFrame.txt"] + [f"cFrame{i}.txt"
                                               for i in range(1, N_FRAMES)]),
            f"xyz run wrote {clouds}")
    maps = np.load(os.path.join(WORK, "locked", f"cFrame{N_FRAMES - 1}.npz"))
    valid = maps["z"] > 0
    pts = np.loadtxt(os.path.join(out, f"cFrame{N_FRAMES - 1}.txt"),
                     dtype=np.float64, ndmin=2)
    require(pts.shape == (int(valid.sum()), 3),
            f"xyz cFrame{N_FRAMES - 1}: {pts.shape[0]} lines, "
            f"{int(valid.sum())} pixels with z > 0")
    err = max(float(np.abs(pts[:, i] - maps[k][valid].astype(np.float64))
                    .max()) for i, k in enumerate("xyz"))
    require(err <= XYZ_BAR, f"xyz values {err} from the maps")
    recs = frame_records(out)
    summary = next(r for r in run_records(out) if r.get("writer"))
    n = summary["writer_frames"]
    log(f"e2e gray xyz (locked, --out-format xyz): fps median "
        f"{statistics.median(x['fps'] for x in recs[2:]):.1f}; writer per "
        f"frame {summary['writer_total_ms'] / n:.3f} ms (device-to-host "
        f"copy {summary['writer_copy_ms'] / n:.3f}, format and write "
        f"{(summary['writer_total_ms'] - summary['writer_copy_ms']) / n:.3f}"
        f"); cFrame{N_FRAMES - 1}.txt {pts.shape[0]} lines, one per pixel "
        f"with z > 0, values within {err:.3e} of the maps (bar 5e-8)")
    return errs


def same_clouds(out_a, out_b, n_frames):
    """The npz clouds of two runs bit for bit (NaN bits too); returns the
    number of files compared."""
    names = sorted(f for f in os.listdir(out_a) if f.endswith(".npz")
                   and f != "depth_iFrame.npz")
    require(names == sorted(f for f in os.listdir(out_b)
                            if f.endswith(".npz")
                            and f != "depth_iFrame.npz")
            and len(names) == n_frames, f"cloud files differ: {names}")
    for name in names:
        a, b = (np.load(os.path.join(o, name)) for o in (out_a, out_b))
        for k in ("x", "y", "z"):
            require(np.array_equal(a[k].view(np.uint32),
                                   b[k].view(np.uint32)),
                    f"{name}.{k}: {out_b} differs from {out_a}")
    return len(names)


def loop_wall_s(recs, first):
    """Host wall of the loop from the record of frame ``first`` to the
    last record (the sum of the records' 1/fps), and its frame count."""
    idx = next(i for i, r in enumerate(recs) if r["frame"] == first)
    return sum(1.0 / r["fps"] for r in recs[idx + 1:]), len(recs) - idx - 1


def stream_runs(launches, errs):
    """Phase 5c: the streaming loop. ``run --chunk 8`` (K steps as one CUDA
    graph replay) on phase 5a's dataset, locked and free, against the
    ``--chunk 1`` runs bit for bit, with exact launch counts; the loop's
    fps with ``--no-clouds`` at ``--chunk`` 1, 8 and 16 on a 65-frame
    dataset and the host wall per frame of a step and of a chunk; the
    writer's device-to-host copy per frame beside
    a pageable copy of the same maps; and ``measure_overlap`` at
    1024x1280 (open-loop step, ``compute_repeats="auto"``)."""
    cfg = REFERENCE_CONFIG
    ds = os.path.join(WORK, "ds")
    calib_path = os.path.join(ds, "parameters.yml")
    planes = 2 * cfg.gray_bits + cfg.phase_steps
    for name, extra, step, ref in (
            ("chunk_locked", [], "dynamic_step_lock", "locked"),
            ("chunk_free", ["--phase-lock", "off"], "dynamic_step", "free")):
        out = os.path.join(WORK, name)
        # A warm-up step, 3 replays of 8 steps and a tail of 5 single
        # steps: N_FRAMES launches, as the per-frame run.
        got = counted_run(
            [ds, "--calib", calib_path, "--out", out, "--chunk", "8",
             *extra],
            lambda: {"grayphase": 2, "stripe": 1, step: N_FRAMES,
                     "lock_window": int(step == "dynamic_step_lock")},
            native_expected(planes, N_FRAMES, lock=name != "chunk_free"))
        for k, v in got.items():
            launches[k] += v
        n = same_clouds(os.path.join(WORK, ref), out, N_FRAMES)
        recs = frame_records(out)
        chunks = [r["t_dynamic_chunk_ms"] for r in recs
                  if "t_dynamic_chunk_ms" in r]
        require(len(chunks) == 3, f"{name}: {len(chunks)} chunks, not 3")
        log(f"e2e gray {name} (--chunk 8): {n} clouds bit-identical to the "
            f"--chunk 1 run's; chunk host wall {chunks} ms (3 replays of 8 "
            f"steps, then 5 single steps)")
    z = np.load(os.path.join(WORK, "chunk_locked",
                             f"cFrame{N_FRAMES - 1}.npz"))["z"]
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    t0 = time.perf_counter()
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, N_LOOP_FRAMES, z0=50.0, dz_per_frame=0.3,
        stripe_period=int(LOCK_T), noise_sigma=1.0)
    err = median_err(z, zs[N_FRAMES - 1], cfg.reco_window // 2 + 2)
    require(err == errs["locked"] and err < 0.05
            and err < 0.5 * errs["free"], f"chunked locked error {err}")
    scene = synth.render_static_scene(calib, cfg, synth.plane_surface(50.0),
                                      noise_sigma=1.0)
    loop_ds = os.path.join(WORK, "loop_ds")
    write_replay_dataset(loop_ds, scene.gray_images, scene.phase_images,
                         frames, config_fields={
                             "pro_h": cfg.pro_h, "pro_w": cfg.pro_w,
                             "gray_bits": cfg.gray_bits,
                             "phase_steps": cfg.phase_steps,
                             "stripe_period": int(LOCK_T)})
    save_calibration(os.path.join(loop_ds, "parameters.yml"), calib)
    log(f"e2e loop: rendered and wrote {N_LOOP_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    card = card_line()
    for k in (1, 8, 16):
        out = os.path.join(WORK, f"loop{k}")
        got = counted_run(
            [loop_ds, "--calib", os.path.join(loop_ds, "parameters.yml"),
             "--out", out, "--chunk", str(k), "--no-clouds"],
            lambda: {"grayphase": 2, "stripe": 1,
                     "dynamic_step_lock": N_LOOP_FRAMES, "lock_window": 1},
            native_expected(planes, N_LOOP_FRAMES))
        for name, v in got.items():
            launches[name] += v
        recs = frame_records(out)
        # From the end of the first chunk of 16 to the last frame: 48
        # frames, whole chunks at K = 8 and 16.
        wall, n = loop_wall_s(recs, 16)
        per = [r["t_dynamic_step_ms"] for r in recs
               if "t_dynamic_step_ms" in r]
        per += [r["t_dynamic_chunk_ms"] / k for r in recs
                if "t_dynamic_chunk_ms" in r]
        log(f"e2e loop --chunk {k} --no-clouds on {card}: fps "
            f"{n / wall:.2f} over frames 17-{N_LOOP_FRAMES - 1} ({n} "
            f"frames, {1e3 * wall / n:.4f} ms a frame); host wall of "
            f"{'slc/dynamic_step' if k == 1 else 'slc/dynamic_chunk / K'} "
            f"per frame, median {statistics.median(per):.4f} ms")

    paths = [os.path.join(loop_ds, "cFrame", f"dynaCam{i}.bmp")
             for i in range(1, N_LOOP_FRAMES)]
    t0 = time.perf_counter()
    for _ in native_io.NativeFrameLoader(paths, cfg.cam_h, cfg.cam_w,
                                         slots=8, threads=4):
        pass
    log(f"e2e loop: the same frames read by the native pool alone (8 "
        f"slots, 4 threads, after the runs) "
        f"{1e3 * (time.perf_counter() - t0) / len(paths):.3f} ms a frame")
    for name in ("locked", "chunk_locked", "xyz"):
        summary = next(r for r in run_records(os.path.join(WORK, name))
                       if r.get("writer"))
        m = summary["writer_frames"]
        log(f"e2e writer {name}: device-to-host copy "
            f"{summary['writer_copy_ms'] / m:.4f} ms a frame (pinned, "
            f"waited on by the writer thread), total "
            f"{summary['writer_total_ms'] / m:.3f} ms a frame")
    maps = [torch.from_numpy(z.astype(np.float32)).cuda() for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        for a in maps:
            a.cpu()
    pageable = 1e3 * (time.perf_counter() - t0) / 10
    hosts = [torch.empty(a.shape, pin_memory=True) for a in maps]
    t0 = time.perf_counter()
    for _ in range(10):
        for h, a in zip(hosts, maps):
            h.copy_(a, non_blocking=True)
        torch.cuda.synchronize()
    pinned = 1e3 * (time.perf_counter() - t0) / 10
    log(f"e2e writer: the 3 maps of a frame device-to-host here, host wall "
        f"{pageable:.4f} ms pageable (.cpu(), the parent's writer) and "
        f"{pinned:.4f} ms pinned (non-blocking copies, one synchronize)")

    dev = torch.device("cuda", 0)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w, dev)
    state = init_tracker(torch.from_numpy(frames[0]).to(dev),
                         torch.from_numpy(pus[0].astype(np.float32)).to(dev),
                         torch.from_numpy(zs[0].astype(np.float32)).to(dev),
                         cfg)
    reset_counts()
    ov = streaming.measure_overlap(state, list(frames[1:9]), tables, cfg,
                                   compute_repeats="auto")
    log(f"measure_overlap at {cfg.cam_h}x{cfg.cam_w}, open-loop step, "
        f"compute_repeats='auto', on {card}: {json.dumps(ov)}")
    require(ov["pipelined_ms"] > 0 and ov["sequential_ms"] > 0
            and 0.0 <= ov["overlap_efficiency"] <= 1.0, f"overlap {ov}")


def capture_and_golden(launches):
    """Phase 5d: ``python -m slc_tpu_torch capture`` at the reference
    config through ``main()``, then ``run`` on its dataset (frame 0
    within 1.0 of z = 50 on > 99% of the points,
    tests/test_capture.py:68); and the golden oracle at a small size: the
    open-loop kernel with the reference's semantics against
    ``golden.dynamic_step`` (P 1e-3, strips exact, tests/test_stripe.py:
    68-84), the Gray decode and the merge on the card against
    ``golden.decode_gray`` (exact) and ``golden.gray_assisted_merge``
    (1e-3, tests/test_decode.py)."""
    cfg = REFERENCE_CONFIG
    cap = os.path.join(WORK, "cap")
    require(slc_main(["capture", cap, "--scene", "plane", "--frames",
                      str(N_CAPTURE_FRAMES)]) == 0, "capture failed")
    out = os.path.join(WORK, "cap_run")
    got = counted_run([cap, "--calib", os.path.join(cap, "parameters.yml"),
                       "--out", out],
                      lambda: {"grayphase": 2, "stripe": 1,
                               "dynamic_step_lock": N_CAPTURE_FRAMES,
                               "lock_window": 1},
                      native_expected(2 * cfg.gray_bits + cfg.phase_steps,
                                      N_CAPTURE_FRAMES))
    for k, v in got.items():
        launches[k] += v
    z = np.load(os.path.join(out, "iFrame.npz"))["z"]
    near = float((np.abs(z[z > 0] - 50.0) < 1.0).mean())
    last = np.load(os.path.join(out, f"cFrame{N_CAPTURE_FRAMES - 1}.npz"))
    log(f"e2e capture at {cfg.cam_h}x{cfg.cam_w}: frame 0 within 1.0 of "
        f"z = 50 on {near:.5f} of {int((z > 0).sum())} points (bar 0.99); "
        f"frame {N_CAPTURE_FRAMES - 1} valid "
        f"{float((last['z'] > 0).mean()):.4f}")
    require(near > 0.99, f"captured frame 0: {near} within 1.0")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    h, w, window = 48, 64, 7
    f0, f1 = (rng.integers(0, 256, size=(h, w), dtype=np.uint8)
              for _ in range(2))
    pu0 = rng.uniform(100.0, 500.0, size=(h, w))
    sw0, sb0 = kstripe.stripe_regression_cuda(
        torch.from_numpy(f0).to(dev), window, subpixel=False)
    small = synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    pu1, sw1, sb1, _, _, _ = kstep.dynamic_step_open_cuda(
        torch.from_numpy(f1).to(dev), sw0, sb0,
        torch.from_numpy(pu0.astype(np.float32)).to(dev),
        build_tables(small, h, w, dev), window=window, subpixel=False,
        scale_gradient=False, robust=False)
    gw0, gb0 = golden.windowed_extrema(golden.box_sum_vertical(f0, window),
                                       window)
    g_pu1, g_sw1, g_sb1, _ = golden.dynamic_step(pu0, gw0, gb0, f1, window)
    require(all(np.array_equal(a.cpu().numpy(), b) for a, b in
                ((sw0, gw0), (sw1, g_sw1), (sb1, g_sb1))),
            "stripe offsets differ from the golden oracle")
    d_step = float(np.abs(pu1.cpu().numpy() - g_pu1).max())
    gray = rng.integers(0, 256, size=(10, 8, 16), dtype=np.uint8)
    gc = decode_gray(torch.from_numpy(gray).to(dev), 5, 640)
    require(np.array_equal(gc.cpu().numpy(),
                           golden.decode_gray(gray, 5, 640)),
            "decode_gray differs from the golden oracle")
    gb = rng.integers(0, 64, size=(32, 48)).astype(np.float64) * 20.0
    ph = rng.uniform(0.0, 40.0, size=(32, 48))
    merged = gray_assisted_merge(
        torch.from_numpy(gb.astype(np.float32)).to(dev),
        torch.from_numpy(ph.astype(np.float32)).to(dev), 20.0, 40.0)
    d_merge = float(np.abs(merged.cpu().numpy()
                           - golden.gray_assisted_merge(gb, ph, 20.0, 40.0))
                    .max())
    log(f"golden oracle: open-loop kernel (reference semantics, {h}x{w}, "
        f"window {window}) P max|diff| {d_step:.3e} (bar 1e-3), strips "
        f"exact; decode_gray exact; gray_assisted_merge max|diff| "
        f"{d_merge:.3e} (bar 1e-3)")
    require(d_step < 1e-3 and d_merge < 1e-3, "golden bars")


def plain_render(z, fx, fy, cx, cy):
    """cloud.render_depth_map with the plain bilateral filter."""
    filtered = kbil.bilateral_filter_ref(z)
    normals, ok = cloud.cloud_normals(
        cloud.depth_to_cloud(filtered, fx, fy, cx, cy), filtered > 0)
    return cloud.luminance_map(cloud.depth_to_cloud(z, fx, fy, cx, cy),
                               normals, ok)


def check_depth_and_previews(out, calib):
    """The locked run's ``--save-depth`` and ``--preview`` outputs:
    depth_iFrame.npz holds frame 0's z bit for bit and the calibration's
    cam_k; each preview BMP is the display of the kernel path's render of
    its frame's depth, and that render is within 1 of the plain chain's
    (the plain bilateral filter) on at most 0.1% of the pixels. Then the
    render's device time per call, kernel and plain, and the host wall of
    one preview written as the runner writes it."""
    cfg = REFERENCE_CONFIG
    d = np.load(os.path.join(out, "depth_iFrame.npz"))
    z0 = np.load(os.path.join(out, "iFrame.npz"))["z"]
    require(d["z"].dtype == np.float32 and d["z"].shape == z0.shape
            and np.array_equal(d["z"].view(np.uint32), z0.view(np.uint32)),
            "depth_iFrame.npz z is not frame 0's bit for bit")
    require(np.array_equal(d["cam_k"], calib.cam_k.numpy()),
            "depth_iFrame.npz cam_k is not the calibration's")
    k = calib.cam_k.numpy()
    kk = (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]))
    last = N_FRAMES - 1
    for bmp, npz in (("preview_iFrame.bmp", "iFrame.npz"),
                     (f"preview_cFrame{last}.bmp", f"cFrame{last}.npz")):
        img = read_bmp(os.path.join(out, bmp))
        require(img.shape == (cfg.cam_h, cfg.cam_w)
                and img.dtype == np.uint8, f"{bmp}: {img.shape} {img.dtype}")
        z = torch.from_numpy(np.load(os.path.join(out, npz))["z"]).cuda()
        lum = cloud.render_depth_map(z, *kk)
        plain = plain_render(z, *kk)
        diff = (lum.int() - plain.int()).abs()
        n_diff = int((diff > 0).sum())
        log(f"  preview {bmp}: kernel vs plain render max|diff| "
            f"{int(diff.max())}, {n_diff} px differ ({n_diff / z.numel():.5%}"
            f"; bar 1 on 0.1%)")
        require(int(diff.max()) <= 1 and n_diff <= 1e-3 * z.numel(),
                f"{bmp}: the kernel path's render is off the plain chain")
        require(np.array_equal(img, visualization.to_display(
            lum.cpu().numpy())), f"{bmp} is not the kernel path's render")
    ms = 1e3 * devtime.device_time_s(lambda: cloud.render_depth_map(z, *kk),
                                     TIME_N, warmup=TIME_WARMUP)
    plain_ms = 1e3 * devtime.device_time_s(lambda: plain_render(z, *kk),
                                           TIME_N, warmup=TIME_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        runner._write_preview(WORK, f"preview_timed{i}", z, calib)
    wall = 1e3 * (time.perf_counter() - t0) / 5
    log(f"e2e preview at {cfg.cam_h}x{cfg.cam_w} on {card_line()}: render "
        f"{ms:.4f} ms a call (CUDA events; plain chain {plain_ms:.4f} ms); "
        f"one preview written as the runner writes it (render, copy to "
        f"the host, display scaling, BMP) {wall:.3f} ms host wall")


def fusion_problem(shape=FUSE_SHAPE, cam_f=None):
    """bench.py:453-521's config-5 frontend: 16 depth maps at 1216x1632
    (or ``shape``) ray-cast from an orbit about the scene centre (0.006 /
    0.025 rad a step) through a camera of focal ``cam_f`` px (130 x w /
    160 by default), initial poses perturbed from seed 7. Returns (args,
    kw, (rot0, trans0, rot_gt, trans_gt)) for ``register_scans(*args,
    **kw)``."""
    h, w, s = tuple(shape) + (FUSE_SCANS,)
    calib = synthetic_calibration(cam_h=h, cam_w=w,
                                  cam_f=cam_f or 130.0 * w / 160.0)
    center = np.array([0.0, 0.0, 62.0])

    def rot_of(v):
        return se3.exp_so3(torch.tensor(v, dtype=torch.float32)).numpy() \
            .astype(np.float64)
    rot_gt = np.stack([rot_of([0.006 * (i - 8), 0.025 * (i - 8), 0.0])
                       for i in range(s)])
    trans_gt = np.stack([(np.eye(3) - r) @ center for r in rot_gt])
    depths = np.stack([synth.render_depth_from_pose(calib, h, w, rot_gt[i],
                                                    trans_gt[i])
                       for i in range(s)]).astype(np.float32)
    rng = np.random.default_rng(7)
    rot0, trans0 = rot_gt.copy(), trans_gt.copy()
    for i in range(1, s):
        rot0[i] = rot_of(rng.normal(0, 0.01, 3)) @ rot0[i]
        trans0[i] = trans0[i] + rng.normal(0, 0.15, 3)
    args = (depths, calib.cam_k.numpy(), rot0.astype(np.float32),
            trans0.astype(np.float32))
    kw = dict(rounds=8, gn_iters=5, grid_step=16, max_depth_err=2.0)
    return args, kw, (rot0, trans0, rot_gt, trans_gt)


def fusion_phase():
    """Phase 6a: 16-scan registration at 2 MP on the card
    (:func:`fusion_problem`). It must reach ATE < 0.05 and < 0.25 x the
    initial ATE, lie within 2e-3 of the same call on the CPU, and return
    the same poses bit for bit when the caller has set
    ``torch.set_float32_matmul_precision("high")``. The timed call must be
    3 launches of the point-to-plane kernels a step; returns their
    count."""
    h, w = FUSE_SHAPE
    t0 = time.perf_counter()
    args, kw, (rot0, trans0, rot_gt, trans_gt) = fusion_problem()
    log(f"fusion: ray-cast {FUSE_SCANS} scans at {h}x{w} in "
        f"{time.perf_counter() - t0:.1f} s; {(h // 16) * (w // 16)} "
        f"landmarks a scan")

    register_scans(*args, device="cuda", **kw)          # warm-up
    torch.cuda.synchronize()
    kp2l.gn_step_p2l_cuda.launches = 0
    t0 = time.perf_counter()
    rot, trans = register_scans(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    p2l_launches = kp2l.gn_step_p2l_cuda.launches
    want = kp2l.LAUNCHES_PER_STEP * kw["rounds"] * kw["gn_iters"]
    require(p2l_launches == want,
            f"register_scans: {p2l_launches} p2l launches, not {want}")
    stages = {}
    register_scans(*args, device="cuda", timings=stages, **kw)
    f32 = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda())
    ate0 = float(fusion.ate_rmse(*map(f32, (rot0, trans0, rot_gt,
                                            trans_gt))))
    ate = float(fusion.ate_rmse(rot, trans, f32(rot_gt), f32(trans_gt)))
    log(f"fusion on {card_line()}: register_scans {wall:.1f} ms wall "
        f"(synchronised, after one warm-up); by stage, each synchronised: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f" (sum {sum(stages.values()):.1f}); ATE {ate:.5f} from "
        f"{ate0:.5f}; {p2l_launches} p2l launches")
    require(ate < 0.05 and ate < 0.25 * ate0,
            f"fusion ATE {ate} (initial {ate0}) misses < 0.05 and < 0.25x")

    t0 = time.perf_counter()
    rot_c, trans_c = register_scans(*args, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    err = max(float((rot.cpu() - rot_c).abs().max()),
              float((trans.cpu() - trans_c).abs().max()))
    log(f"fusion: card vs CPU poses max|diff| {err:.3e} (bar 2e-3); the CPU "
        f"call took {cpu_s:.1f} s on {host_cpu()}")
    require(err <= 2e-3, f"card poses {err} from the CPU's")

    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        rot_h, trans_h = register_scans(*args, device="cuda", **kw)
    finally:
        torch.set_float32_matmul_precision(prec)
    same = torch.equal(rot_h, rot) and torch.equal(trans_h, trans)
    log(f"fusion: with float32 matmul precision 'high' set by the caller "
        f"the poses are {'bit-identical' if same else 'DIFFERENT'}")
    require(same, "register_scans depends on the caller's TF32 setting")
    return p2l_launches


def p2l_phase():
    """Phase 6, after 6a: the point-to-plane step's kernels (``csrc/p2l.cu``) at
    sweep16's shape: 16 views at 1024x1280 through the rig's 600-px
    camera, associated at grid step 16 and normal radius 7 (L = 81,920).
    The kernel step must lie within 1e-5 of the plain step (run plain on
    the card through an identity ``reduce_fn``) from the true poses, as
    tests/test_torch_cuda.py holds it, and be 3 launches. From the
    perturbed poses, where the step is large (printed), it must lie within
    1e-5 on rotation entries and 1e-4 on translation components of the
    plain step evaluated in float64, as the card tests hold it. Then, from
    those poses: the kernels alone (20 steps in one CUDA graph), the
    kernel step's call and the plain step's call (CUDA events), the plain
    step's kernels (the profiler's records, where it records them), and
    the bound: one read from device memory of obs and mask (16 B a pair)
    and the landmarks and normals (24 B a landmark). The kernels' design
    reads them twice, once a pass, and pass 2's obs and mask may come
    from the 50 MB L2; the two-pass figure is printed beside it. Returns
    the kernel's line of the JSON summary, whose ``launches`` the caller
    fills from the main path's runs."""
    dev = torch.device("cuda", 0)
    args, _, (rot0, trans0, rot_gt, trans_gt) = fusion_problem(
        (1024, 1280), 600.0)
    depths, cam_k = (torch.from_numpy(a).to(dev) for a in args[:2])
    f32 = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev))

    def inputs(rot, trans):
        rot, trans = f32(rot), f32(trans)
        obs, mask, lm, nrm = associate_projective(depths, cam_k, rot, trans,
                                                  16, 2.0, 7)
        return rot, trans, lm, nrm, obs, mask

    def plain(*a, dtype=torch.float32):
        with fusion.full_f32():
            return fusion._gn_step_p2l(*(t.to(dtype) for t in a), 1e-3,
                                       reduce_fn=lambda x: x)

    exact = inputs(rot_gt, trans_gt)
    kp2l.gn_step_p2l_cuda.launches = 0
    got = fusion._gn_step_p2l(*exact, 1e-3)
    require(kp2l.gn_step_p2l_cuda.launches == kp2l.LAUNCHES_PER_STEP,
            f"p2l step: {kp2l.gn_step_p2l_cuda.launches} launches")
    want = plain(*exact)
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    require(err <= 1e-5 and int(got[3]) == 0,
            f"p2l step {err} from the plain step (bar 1e-5), info "
            f"{int(got[3])}")

    rot, trans, lm, nrm, obs, mask = inputs(rot0, trans0)
    s, l = mask.shape
    moved = fusion._gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3)
    exact64 = plain(rot, trans, lm, nrm, obs, mask, dtype=torch.float64)
    gap_r, gap_t = (float((g.double() - w).abs().max())
                    for g, w in zip(moved[:2], exact64[:2]))
    step_r, step_t = (float((w - a.double()).abs().max())
                      for w, a in zip(exact64[:2], (rot, trans)))
    log(f"p2l step from the perturbed poses (the float64 step moves "
        f"rotation entries by up to {step_r:.3e}, translation components "
        f"by up to {step_t:.3e}): the kernels' step {gap_r:.3e} and "
        f"{gap_t:.3e} from it (bars 1e-5 and 1e-4), info {int(moved[3])}")
    require(gap_r <= 1e-5 and gap_t <= 1e-4 and int(moved[3]) == 0,
            f"p2l step from the perturbed poses {gap_r}, {gap_t} from the "
            f"float64 step (bars 1e-5, 1e-4), info {int(moved[3])}")
    work = kp2l.P2LWork(s, l, dev)
    work.rot.copy_(rot)
    work.trans.copy_(trans)

    def kern():
        kp2l.gn_step_p2l_cuda(work.rot, work.trans, lm, nrm, obs, mask, 1e-3,
                              work)

    def plain_step():
        plain(rot, trans, lm, nrm, obs, mask)
    kp2l.gn_step_p2l_cuda.launches = 0
    k_call = 1e3 * devtime.device_time_s(kern, TIME_N, None, TIME_WARMUP)
    k_alone = 1e3 * devtime.graph_time_s(kern, TIME_N, TIME_WARMUP)
    steps = 2 * (TIME_N + TIME_WARMUP)
    require(kp2l.gn_step_p2l_cuda.launches
            == kp2l.LAUNCHES_PER_STEP * steps,
            f"p2l timing: {kp2l.gn_step_p2l_cuda.launches} launches for "
            f"{steps} steps")
    p_call = 1e3 * devtime.device_time_s(plain_step, TIME_N, None,
                                         TIME_WARMUP)
    try:
        p_alone = 1e3 * devtime.device_time_s(plain_step, TIME_N, "",
                                              TIME_WARMUP)
    except devtime.ProfilerUnavailable:
        p_alone = None
    nbytes = 16 * s * l + 24 * l
    peak = devtime.HBM_PEAK_GBPS.get(torch.cuda.get_device_name(0))
    bound = 1e3 * nbytes / (peak * 1e9) if peak else None
    two_pass = 2 * bound if peak else None
    log(f"time p2l step at S={s}, L={l} on {card_line()}: kernels alone "
        f"(graph of {TIME_N} steps) {k_alone:.4f} ms a step, call "
        f"{k_call:.4f} ms; plain step call {p_call:.4f} ms, its kernels "
        + (f"{p_alone:.4f} ms" if p_alone is not None else "not measured")
        + f"; {kp2l.LAUNCHES_PER_STEP} launches a step; bound "
        + (f"{bound:.4f} ms (one read of {nbytes / 1e6:.1f} MB; the "
           f"kernels alone at {100.0 * bound / k_alone:.1f}% of it), the "
           f"design's two passes {two_pass:.4f} ms "
           f"({100.0 * two_pass / k_alone:.1f}%)" if bound else
           "not known for this card")
        + f"; from the true poses {err:.3e} from the plain step")
    line = {"name": "p2l", "route": "cuda",
            "source": "slc_tpu_torch/kernels/csrc/p2l.cu",
            "replaces": "port-only", "launches": None,
            "max_abs_err": err, "ms": k_call, "plain_ms": p_call,
            "bound_ms": bound, "bound_by": "bytes" if bound else None,
            "library_ms": None, "kernel_only_ms": k_alone,
            "two_pass_bound_ms": two_pass}
    if p_alone is not None:
        line["plain_kernel_only_ms"] = p_alone
    return line


def fuse_cli_run():
    """Phase 6b: ``python -m slc_tpu_torch fuse`` through ``main()`` on 3
    depth files at 1024x1280 (tests/test_fuse_cli.py:17-36's motions):
    poses.json must meet that test's bar and fused.txt hold more than two
    scans' pixels, and its registration be 3 launches of the
    point-to-plane kernels a step. Returns their count."""
    h, w = REFERENCE_CONFIG.cam_h, REFERENCE_CONFIG.cam_w
    calib = synthetic_calibration(cam_h=h, cam_w=w, cam_f=110.0 * w / 128.0)
    cam_k = calib.cam_k.numpy()
    paths, trans_gt = [], []
    for i in range(3):
        r = se3.exp_so3(torch.tensor([0.0, 0.02 * i, 0.0])).numpy() \
            .astype(np.float64)
        t = np.array([0.5 * i, 0.05 * i, -0.1 * i])
        trans_gt.append(t)
        p = os.path.join(WORK, f"scan{i}", "depth_iFrame.npz")
        os.makedirs(os.path.dirname(p))
        np.savez(p, z=synth.render_depth_from_pose(calib, h, w, r, t)
                 .astype(np.float32), cam_k=cam_k)
        paths.append(p)
    out = os.path.join(WORK, "fused")
    rounds, gn_iters = 6, 5
    kp2l.gn_step_p2l_cuda.launches = 0
    t0 = time.perf_counter()
    rc = slc_main(["fuse", *paths, "--out", out, "--device", "cuda",
                   "--rounds", str(rounds), "--gn-iters", str(gn_iters),
                   "--grid-step", "6", "--max-depth-err", "2.0"])
    wall = time.perf_counter() - t0
    require(rc == 0, f"fuse exited {rc}")
    launches = kp2l.gn_step_p2l_cuda.launches
    want = kp2l.LAUNCHES_PER_STEP * rounds * gn_iters
    require(launches == want, f"fuse: {launches} p2l launches, not {want}")
    with open(os.path.join(out, "poses.json")) as f:
        poses = json.load(f)["world_from_scan"]
    errs = [float(np.linalg.norm(np.asarray(poses[i]["trans"]) - trans_gt[i]))
            for i in (1, 2)]
    with open(os.path.join(out, "fused.txt")) as f:
        lines = sum(1 for _ in f)
    log(f"e2e fuse CLI: 3 scans at {h}x{w}, {wall:.1f} s wall (register, "
        f"poses.json, fused.txt by np.savetxt); translation errors "
        f"{errs[0]:.4f}, {errs[1]:.4f}; fused.txt {lines} lines; "
        f"{launches} p2l launches")
    for i, e in zip((1, 2), errs):
        require(e < 0.25 * np.linalg.norm(trans_gt[i]) + 0.05,
                f"fuse scan {i}: translation error {e}")
    require(lines > 2 * h * w, f"fused.txt has {lines} lines")
    return launches


def mg_shapes(h, w):
    """The level shapes of U.build_mg_levels at (h, w), fine to coarse."""
    shapes = [(h, w)]
    while min(shapes[-1]) > U.MG_COARSEST:
        lh, lw = shapes[-1]
        shapes.append((-(-lh // 2), -(-lw // 2)))
    return shapes


def coarse_visits(h, w):
    """Launches of mg_coarse per preconditioner call: the K-cycle's
    visits of the coarsest level (counted as :func:`mg_kernel_visits`
    counts a level's), 0 where that level is too large for the kernel."""
    shapes = mg_shapes(h, w)
    visits, kdepth = 1, U.MG_KDEPTH
    for i in range(len(shapes) - 1):
        if kdepth > 0 and len(shapes) - i > 2:
            visits, kdepth = 2 * visits, kdepth - 1
    return visits if U.coarse_kernel_fits(*shapes[-1]) else 0


def mg_kernel_visits(h, w):
    """Launches of each multigrid kernel per preconditioner call, by
    level: the levels of U.build_mg_levels at least MG_KERNEL_MIN on both
    sides, each once per visit; a K-cycle level visits the next one
    twice. {(h, w): launches}."""
    shapes = mg_shapes(h, w)
    out, visits, kdepth = {}, 1, U.MG_KDEPTH
    for i, (lh, lw) in enumerate(shapes[:-1]):
        if U.MG_NU == 2 and min(lh, lw) >= U.MG_KERNEL_MIN:
            out[(lh, lw)] = visits
        if kdepth > 0 and len(shapes) - i > 2:
            visits, kdepth = 2 * visits, kdepth - 1
    return out


def mg_ms_per_call(level_ms, kernel):
    """A multigrid kernel's device ms per preconditioner call at the
    reference shape: launches per level x its kernels-alone time there."""
    visits = mg_kernel_visits(*SHAPES[0])
    return sum(n * level_ms[shape][kernel] for shape, n in visits.items())


def fringe_runs(dev, launches, level_ms):
    """Phase 5b: the heterodyne and spatial frame-0 decodes through the
    CLI, on a synth-style dataset with the fringe stack."""
    cfg = REFERENCE_CONFIG
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    t0 = time.perf_counter()
    plane = synth.plane_surface(50.0)
    dz = 0.08
    scene = synth.render_static_scene(calib, cfg, plane, noise_sigma=1.0)
    fringes, _, _ = synth.render_fringe_stack(
        calib, cfg, plane, HET.periods(cfg.pro_w), HET.phase_steps,
        noise_sigma=1.0)
    frames, zs, _ = synth.render_dynamic_sequence(
        calib, cfg, N_FRINGE_FRAMES, z0=50.0, dz_per_frame=dz,
        stripe_period=int(LOCK_T), noise_sigma=1.0,
        surface_for_frame=lambda f: synth.offset_surface(plane, dz * f))
    ds = os.path.join(WORK, "fringe_ds")
    write_replay_dataset(ds, scene.gray_images, scene.phase_images, frames,
                         fringes,
                         config_fields={"pro_h": cfg.pro_h,
                                        "pro_w": cfg.pro_w,
                                        "gray_bits": cfg.gray_bits,
                                        "phase_steps": cfg.phase_steps,
                                        "scene": "plane",
                                        "stripe_period": int(LOCK_T)})
    calib_path = os.path.join(ds, "parameters.yml")
    save_calibration(calib_path, calib)
    log(f"e2e fringes: rendered and wrote {N_FRINGE_FRAMES} frames and "
        f"{HET.num_images} fringe images in {time.perf_counter() - t0:.1f} s")
    margin = cfg.reco_window // 2 + 2

    out = os.path.join(WORK, "heterodyne")
    got = counted_run([ds, "--calib", calib_path, "--out", out, "--mode",
                       "heterodyne"],
                      lambda: {"heterodyne": 2, "stripe": 1,
                               "dynamic_step_lock": N_FRINGE_FRAMES,
                               "lock_window": 1},
                      native_expected(HET.num_images, N_FRINGE_FRAMES))
    for k, v in got.items():
        launches[k] += v
    recs = frame_records(out)
    last = N_FRINGE_FRAMES - 1
    err0 = median_err(np.load(os.path.join(out, "iFrame.npz"))["z"],
                      scene.z_gt, margin)
    err_last = median_err(np.load(os.path.join(out, f"cFrame{last}.npz"))["z"],
                          zs[last], margin)
    log(f"e2e heterodyne: median|z err| frame 0 {err0:.5f}, frame {last} "
        f"{err_last:.5f}, t_first_frame_ms {recs[0]['t_first_frame_ms']}")
    require(err0 < 0.05 and err_last < 0.05,
            f"heterodyne errors too large: {err0}, {err_last}")

    out = os.path.join(WORK, "spatial")
    per_cycle = sum(mg_kernel_visits(cfg.cam_h, cfg.cam_w).values())
    coarse_per_cycle = coarse_visits(cfg.cam_h, cfg.cam_w)
    period = float(cfg.phase_period)
    p0 = torch.from_numpy(scene.phase_images).to(dev)
    info = {}

    def spatial_expected():
        # The same input, decoded directly after the run: its CG
        # iteration count sets the multigrid launches of each decode.
        _, inf = U.unwrap_spatial(decode_phase(p0, period), period,
                                  quality=modulation(p0), return_info=True)
        info.update(inf)
        mg = 2 * per_cycle * (inf["cg_iters"] + 1)
        return {"bilateral": 2, "mg_down": mg, "mg_up": mg,
                "mg_coarse": 2 * coarse_per_cycle * (inf["cg_iters"] + 1),
                "stripe": 1, "dynamic_step_lock": N_FRINGE_FRAMES,
                "lock_window": 1}

    got = counted_run([ds, "--calib", calib_path, "--out", out, "--mode",
                       "spatial"], spatial_expected,
                      native_expected(cfg.phase_steps, N_FRINGE_FRAMES))
    for k, v in got.items():
        launches[k] += v
    recs = frame_records(out)
    log(f"e2e spatial: cg_iters {info['cg_iters']} at "
        f"{cfg.cam_h}x{cfg.cam_w}, rel_residual "
        f"{float(info['rel_residual']):.3e}, {per_cycle} launches of each "
        f"multigrid kernel per preconditioner call, so "
        f"{per_cycle * (info['cg_iters'] + 1)} per decode; "
        f"t_first_frame_ms {recs[0]['t_first_frame_ms']}")
    calls = info["cg_iters"] + 1
    log("e2e spatial: multigrid kernels per decode, kernels alone "
        f"(phase 4's per-call times x {calls} calls): " + ", ".join(
            f"{k} {calls * mg_ms_per_call(level_ms, k):.4f} ms"
            for k in ("mg_down", "mg_up")))
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w, dev)
    direct = decode_spatial_frame(p0, tables, cfg, period)
    cloud = np.load(os.path.join(out, "iFrame.npz"))
    for k in ("z", "x", "y"):
        diff = np.abs(cloud[k] - getattr(direct, k).cpu().numpy()).max()
        log(f"  spatial iFrame.{k} vs direct decode: max|diff| {diff:.3e}")
        require(diff <= 1e-4, f"spatial iFrame.{k} differs by {diff}")
    pu = direct.proj_u.cpu().numpy()
    lit = (scene.proj_u >= 0) & (scene.proj_u < cfg.pro_w)
    decoded = pu != 0
    frac = float(decoded[lit].mean())
    inner = np.zeros_like(decoded)
    inner[margin:-margin, margin:-margin] = True
    sel = decoded & inner
    orders, n = np.unique(np.round((pu - scene.proj_u) / period)[sel],
                          return_counts=True)
    k0 = float(orders[np.argmax(n)])
    cong = float((np.abs(pu[sel] - scene.proj_u[sel] - k0 * period)
                  < 1.0).mean())
    log(f"e2e spatial: decoded {frac:.5f} of the lit pixels; P congruent "
        f"to the truth at a global offset of {k0:+.0f} periods on "
        f"{cong:.5f} of the decoded interior; depth valid on "
        f"{float((cloud['z'] > 0).mean()):.5f} of frame 0")
    require(frac > 0.9, f"spatial decode covers only {frac} of the lit px")
    require(cong >= 0.99, f"spatial P congruent on only {cong}")
    spatial_graph_timing(p0, tables, cfg, period, direct,
                         per_cycle * (info["cg_iters"] + 1),
                         coarse_per_cycle * (info["cg_iters"] + 1))


class EagerCG:
    """Stands in for ``U._cg_graphs``: the unwrap's CG loop launch by
    launch on the card."""

    def __init__(self, dev, h, w, period, tol, mg):
        self.args = (period, tol, mg)

    def run(self, psi, quality, anc, max_iters):
        return U._cg_eager(psi, quality, anc, *self.args, max_iters)


def spatial_graph_timing(p0, tables, cfg, period, direct, mg_launches,
                         coarse_launches):
    """Phase 5b's spatial decode timed through the CG's two CUDA graphs
    and through the eager loop, one after the other: host ms to a
    synchronise, the first graph call after the graphs are dropped
    (their capture, then the replays) and three calls of each path in
    turns. Every map must equal the direct decode's bit for bit, and
    each path launch ``mg_launches`` of each level kernel and
    ``coarse_launches`` of mg_coarse a decode."""
    def decode(eager):
        real = U._cg_graphs
        if eager:
            U._cg_graphs = EagerCG
        kmg.mg_down_cuda.launches = kmg.mg_up_cuda.launches = 0
        kmg.mg_coarse_cuda.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = decode_spatial_frame(p0, tables, cfg, period)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            U._cg_graphs = real
        what = "eager" if eager else "graphs"
        for k in ("z", "proj_u"):
            require(torch.equal(getattr(res, k), getattr(direct, k)),
                    f"spatial decode through the {what}: {k} differs")
        got = (kmg.mg_down_cuda.launches, kmg.mg_up_cuda.launches)
        require(got == (mg_launches, mg_launches),
                f"spatial decode through the {what}: level kernel launches "
                f"{got}, expected {mg_launches} each")
        require(kmg.mg_coarse_cuda.launches == coarse_launches,
                f"spatial decode through the {what}: mg_coarse launches "
                f"{kmg.mg_coarse_cuda.launches}, expected {coarse_launches}")
        return ms

    U._cg_graphs.cache_clear()
    first = decode(False)
    ms = {False: [], True: []}
    for eager in (False, True, True, False, False, True):
        ms[eager].append(decode(eager))
    graphs, eager = (float(np.median(ms[e])) for e in (False, True))
    log(f"e2e spatial: decode_spatial_frame {cfg.cam_h}x{cfg.cam_w} through "
        f"the CG graphs {graphs:.2f} ms, the eager loop {eager:.2f} ms "
        f"(medians of 3, in turns; graphs "
        f"{', '.join(f'{v:.2f}' for v in ms[False])}, eager "
        f"{', '.join(f'{v:.2f}' for v in ms[True])}); first graph call {first:.2f} ms, so the "
        f"capture ~{first - graphs:.2f} ms; {mg_launches} launches of each "
        f"level kernel and {coarse_launches} of mg_coarse a decode on both")


def tiled_mg_visits(h, w):
    """Launches of each multigrid kernel per preconditioner call of
    ``tiled_unwrap_spatial`` on a 1x1 mesh: the single-device schedule
    (:func:`mg_kernel_visits`) on the replicated levels only, those from
    the first level whose tile has an odd side (or the coarsest) down."""
    shapes = mg_shapes(h, w)
    n_shard, (th, tw) = 0, (h, w)
    while min(th, tw) > U.MG_COARSEST and th % 2 == 0 and tw % 2 == 0:
        n_shard, th, tw = n_shard + 1, th // 2, tw // 2
    return {k: v for k, v in mg_kernel_visits(h, w).items()
            if k in shapes[n_shard:]}


def unwrap_scene(h, w, seed=1234):
    """tests/test_unwrap_spatial.py:111-126's box-step scene at (h, w): a
    ramp 5 periods wide and 0.4 px a row, a raised box 3.7 periods high
    with its 2-px edge ring at quality 0, noise 0.05, an anchor perturbed
    by up to a third of a period. Returns (t, psi, q, anchor, good),
    ``good`` the pixels off the ring."""
    rng = np.random.default_rng(seed)
    t = 32.0
    x = (np.linspace(0, 5 * t, w)[None, :]
         + 0.4 * np.arange(h)[:, None]).astype(np.float64)
    box = np.zeros((h, w), bool)
    box[h // 3: 2 * h // 3, w // 3: 2 * w // 3] = True
    x = x + 3.7 * t * box
    psi = np.mod(x + rng.normal(0, 0.05, (h, w)), t).astype(np.float32)
    inner = np.zeros_like(box)
    inner[h // 3 + 2: 2 * h // 3 - 2, w // 3 + 2: 2 * w // 3 - 2] = True
    outer = np.zeros_like(box)
    outer[h // 3 - 2: 2 * h // 3 + 2, w // 3 - 2: 2 * w // 3 + 2] = True
    ring = outer & ~inner
    q = np.where(ring, 0.0, 1.0).astype(np.float32)
    anchor = (x + rng.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    return t, psi, q, anchor, ~ring


def counted(fn, want, what):
    """``fn()`` with every launch count set to 0 just before and read just
    after; the counts must equal ``want`` (others 0). Returns (fn's
    result, the counts)."""
    reset_counts()
    out = fn()
    got = read_counts()
    expect = {k: 0 for k in WRAPPERS}
    expect.update(want(out) if callable(want) else want)
    log(f"parallel: {what} launches {got}")
    require(got == expect, f"{what}: launch counts {got} != {expect}")
    return out, got


def wall_per_call_ms(fn, calls):
    """Host wall of ``calls`` calls of ``fn`` ending in a synchronise,
    per call, after one warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def parallel_phase(dev, launches):
    """Phase 7: the tile-parallel paths (``slc_tpu_torch.parallel``) on a
    world-size-1 NCCL mesh at the reference config, each against the
    port's single-device function on the card; then
    ``dryrun_multichip`` over every card of the host."""
    from slc_tpu_torch.dynamic import TrackerState
    from slc_tpu_torch.entry import dryrun_multichip
    from slc_tpu_torch.parallel import (gather_image, launch as plaunch,
                                        shard_image, tile_mesh,
                                        tiled_absolute_decode,
                                        tiled_batched_dynamic_step,
                                        tiled_dynamic_step,
                                        tiled_stripe_regression,
                                        tiled_unwrap_spatial)
    from slc_tpu_torch.parallel.fusion_tiled import (fusion_mesh,
                                                     shard_landmarks,
                                                     tiled_fuse_scans)
    from slc_tpu_torch.parallel.mesh import mesh_dims

    card = card_line()
    ctx = plaunch.initialize(
        "file://" + os.path.join(WORK, "nccl_store"), 1, 0, device="cuda",
        timeout_s=300)
    require(ctx.backend == "nccl" and ctx.process_count == 1,
            f"parallel: joined {ctx}")
    try:
        mesh = tile_mesh()
        log(f"parallel: NCCL process group of {ctx.process_count}, mesh "
            f"{mesh_dims(mesh)} on {ctx.device}")
        cfg = REFERENCE_CONFIG
        calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                      pro_h=cfg.pro_h, pro_w=cfg.pro_w)
        tables = build_tables(calib, cfg.cam_h, cfg.cam_w, dev)

        # 7a: the absolute decode; no kernel on the tiled path.
        scene = synth.render_static_scene(calib, cfg,
                                          synth.plane_surface(50.0),
                                          noise_sigma=1.0)
        gray = torch.from_numpy(scene.gray_images).to(dev)
        phase = torch.from_numpy(scene.phase_images).to(dev)
        got, _ = counted(lambda: tiled_absolute_decode(
            shard_image(gray, mesh), shard_image(phase, mesh), tables, cfg,
            mesh), {}, "tiled_absolute_decode")
        keys = ("proj_u", "x", "y", "z")
        got = tuple(gather_image(getattr(got, k), mesh) for k in keys)
        x, y, z, pu = kgray.grayphase_decode_ref(gray, phase, tables, cfg)
        same = all(torch.equal(g, e) for g, e in zip(got, (pu, x, y, z)))
        log(f"parallel: tiled absolute decode {cfg.cam_h}x{cfg.cam_w} "
            f"{'equal to' if same else 'DIFFERS from'} the plain decode")
        require(same, "tiled absolute decode differs from the plain one")
        x, y, z, pu = kgray.grayphase_decode_cuda(gray, phase, tables, cfg)
        compare("grayphase", got, (pu, x, y, z), keys, {})

        # 7b: the open-loop steps over phase 5's 30-frame gray dataset.
        frames, zs, pus = synth.render_dynamic_sequence(
            calib, cfg, N_FRAMES, z0=50.0, dz_per_frame=0.3,
            stripe_period=int(LOCK_T), noise_sigma=1.0)
        frames = torch.from_numpy(frames).to(dev)
        sw, sb = tiled_stripe_regression(frames[0], cfg, mesh)
        init = TrackerState(proj_u=torch.from_numpy(pus[0]).float().to(dev),
                            strip_w=sw, strip_b=sb,
                            z=torch.from_numpy(zs[0]).float().to(dev),
                            frame_idx=0)
        kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
                  fov_max=cfg.fov_max)

        def plain_step(st, f):
            out = kstep.dynamic_step_open_ref(
                frames[f], st.strip_w, st.strip_b, st.proj_u, tables, **kw)
            return TrackerState(*out[:4], frame_idx=st.frame_idx + 1)

        def batched_step(st, f):
            new, _, met = tiled_batched_dynamic_step(
                TrackerState(*(a[None] for a in (st.proj_u, st.strip_w,
                                                  st.strip_b, st.z)),
                             frame_idx=st.frame_idx),
                frames[f][None], tables, cfg, mesh)
            return TrackerState(new.proj_u[0], new.strip_w[0],
                                new.strip_b[0], new.z[0], new.frame_idx)

        def run(step):
            st, out = init, []
            for f in range(1, N_FRAMES):
                st = step(st, f)
                out.append((st.proj_u, st.z))
            return out

        want = run(plain_step)
        worst = {}
        for name, step in (
                ("tiled_dynamic_step",
                 lambda st, f: tiled_dynamic_step(st, frames[f], tables, cfg,
                                                  mesh)[0]),
                ("tiled_batched_dynamic_step", batched_step)):
            got, _ = counted(lambda: run(step), {}, name)
            err_p = max(float((g[0] - e[0]).abs().max())
                        for g, e in zip(got, want))
            err_z = max(float((g[1] - e[1]).abs().max())
                        for g, e in zip(got, want))
            worst[name] = (err_p, err_z)
            log(f"parallel: {name} over {N_FRAMES - 1} frames vs the plain "
                f"open-loop step: max|dP| {err_p:.3e} (bar 1e-4), max|dz| "
                f"{err_z:.3e} (bar 1e-3)")
            require(err_p <= 1e-4 and err_z <= 1e-3,
                    f"{name}: P {err_p}, z {err_z} off the plain step")

        def kernel_step(f):
            kstep.dynamic_step_open_cuda(frames[f], init.strip_w,
                                         init.strip_b, init.proj_u, tables,
                                         **kw)

        calls = {
            "plain": lambda f: plain_step(init, 1 + f % (N_FRAMES - 1)),
            "tiled": lambda f: tiled_dynamic_step(
                init, frames[1 + f % (N_FRAMES - 1)], tables, cfg, mesh),
            "tiled_batched": lambda f: batched_step(
                init, 1 + f % (N_FRAMES - 1)),
            "kernel": lambda f: kernel_step(1 + f % (N_FRAMES - 1))}
        walls = {k: [] for k in calls}
        for name in list(calls) + list(calls)[::-1]:
            walls[name].append(wall_per_call_ms(calls[name], N_FRAMES - 1))
        log(f"parallel on {card}: host wall per frame of the open-loop step "
            f"at {cfg.cam_h}x{cfg.cam_w} ({N_FRAMES - 1} calls ending in a "
            f"synchronise, two readings in turns): " + "; ".join(
                f"{k} {', '.join(f'{v:.4f}' for v in vs)} ms"
                for k, vs in walls.items()))

        # 7c: the spatial unwrap; mg_down / mg_up run on the replicated
        # levels of at least MG_KERNEL_MIN px, mg_coarse on the replicated
        # coarsest level, visited as in the single-device K-cycle.
        for h, w in SHAPES:
            t, psi, q, anchor, good = unwrap_scene(h, w)
            psi, q, anchor = (torch.from_numpy(a).to(dev)
                              for a in (psi, q, anchor))
            per_call = sum(tiled_mg_visits(h, w).values())

            def tiled():
                return tiled_unwrap_spatial(
                    shard_image(psi, mesh), t, mesh,
                    quality=shard_image(q, mesh), max_iters=800,
                    anchor=shard_image(anchor, mesh), return_info=True)

            tiled()                                        # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (p_t, info_t), got = counted(
                tiled, lambda out: {
                    "mg_down": per_call * (out[1]["cg_iters"] + 1),
                    "mg_up": per_call * (out[1]["cg_iters"] + 1),
                    "mg_coarse": coarse_visits(h, w)
                    * (out[1]["cg_iters"] + 1)},
                f"tiled_unwrap_spatial {h}x{w}")
            torch.cuda.synchronize()
            wall_t = 1e3 * (time.perf_counter() - t0)
            for k, v in got.items():
                launches[k] += v
            if (h, w) == SHAPES[1]:
                require(got["mg_down"] > 0 and got["mg_up"] > 0,
                        f"tiled unwrap at {h}x{w} launched no multigrid "
                        f"kernel")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_s, info_s = U.unwrap_spatial(psi, t, quality=q, max_iters=800,
                                           anchor=anchor, return_info=True)
            torch.cuda.synchronize()
            wall_s = 1e3 * (time.perf_counter() - t0)
            p_t = gather_image(p_t, mesh)
            g = torch.from_numpy(good).to(dev)
            err = float(torch.where(g, (p_t - p_s).abs(), 0.0).max())
            diag = ("cg_iters", "residue_count", "suspect_count",
                    "anchor_disagreement_count")
            log(f"parallel on {card}: tiled_unwrap_spatial {h}x{w}: wall "
                f"{wall_t:.1f} ms, cg_iters {info_t['cg_iters']}, "
                f"{per_call} launches of each multigrid kernel per "
                f"preconditioner call; unwrap_spatial {wall_s:.1f} ms; "
                f"max|dP| off the ring {err:.3e} (bar 1e-3); tiled / "
                f"single: " + ", ".join(
                    f"{k} {int(info_t[k])} / {int(info_s[k])}"
                    for k in diag))
            require(abs(info_t["cg_iters"] - info_s["cg_iters"]) <= 1,
                    f"tiled unwrap {h}x{w}: cg_iters {info_t['cg_iters']} "
                    f"vs {info_s['cg_iters']}")
            require(err <= 1e-3, f"tiled unwrap {h}x{w}: P off by {err}")

        # 7d: landmark-sharded fusion on bench.py:427-431's parity problem,
        # against the single-device solver at the same damping.
        obs, mask, _, _ = fusion.synthetic_problem(
            np.random.default_rng(5), s=16, l=128, noise=0.01, device=dev)
        fmesh = fusion_mesh()
        rot_d, trans_d, _ = tiled_fuse_scans(
            *shard_landmarks(fmesh, obs, mask), fmesh, iters=10)
        rot_1, trans_1, _ = fusion.fuse_scans(obs, mask, iters=10,
                                              damping=1e-6)
        delta = max(float((rot_d - rot_1).abs().max()),
                    float((trans_d - trans_1).abs().max()))
        log(f"parallel: tiled_fuse_scans (16 scans, 128 landmarks) vs "
            f"fuse_scans: max|diff| {delta:.3e} (bar 1e-4)")
        require(delta < 1e-4, f"tiled fusion off by {delta}")
    finally:
        plaunch.shutdown()

    # 7e: every card of this host, one rank each.
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = dryrun_multichip(n, timeout_s=600)
    log(f"parallel: dryrun_multichip({n}) on {card}: {out['line']} "
        f"({time.perf_counter() - t0:.1f} s with the ranks' start)")
    require(out["backend"] == "nccl", f"dryrun backend {out['backend']}")


def step_args(cfg, kw):
    """The step wrappers' keywords for a tracker's flags (dynamic_step's
    mapping: the lock period and window become period, win_u, win_v)."""
    out = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
               fov_max=cfg.fov_max, subpixel=kw.get("subpixel", True),
               scale_gradient=kw.get("scale_gradient", True),
               robust=kw.get("robust", True))
    if kw.get("phase_lock") is not None:
        out.update(period=float(kw["phase_lock"]), win_u=kw["lock_win_u"],
                   win_v=kw["lock_win_v"])
    return out


def lock_ties(frame, pred, pu, lock, bar, amp_floor=8.0):
    """The pixels where the locked step's kernel ``pu`` may part from the
    plain step by more than ``bar`` (see FOV_TIES), by kind: the plain
    step's lock
    decisions on its own prediction ``pred`` lie within the bar's phase
    (2 pi x bar / T) of a branch point, or its amplitude within 1e-4 of
    the floor's (the amplitude gate); or the kernel lies within the bar
    of the same demodulation in float64, where the float32 plain
    version's cumulative sums lose precision (low amplitude under bright
    rows)."""
    dphi, dpos, dneg, conf, amp = demod.lock_in(frame, pred, **lock)
    margin = torch.stack([np.pi - dphi.abs(), (dpos.abs() - dneg.abs()).abs(),
                          np.pi - dpos.abs(), np.pi - dneg.abs()]).amin(0)
    dphi, dpos, dneg, conf, amp64 = demod.lock_in(frame, pred, **lock,
                                                  dtype=torch.float64)
    d = torch.where(dpos.abs() <= dneg.abs(), dpos, dneg)
    ok = (amp64 > amp_floor) & (pred > 0)
    exact = pred + torch.where(ok, (dphi + conf * d)
                               * (lock["period"] / (2.0 * np.pi)), 0.0)
    return {"branch": margin < 2.0 * np.pi * bar / lock["period"],
            "gate": (amp - amp_floor).abs() <= 1e-4 * amp_floor,
            "float64": (pu - exact).abs() <= bar}


def held_step(state, frame, tables, cfg, kw, errs, gates=None):
    """One tracker step through the dispatching step wrapper that
    ``dynamic.dynamic_step`` calls (the kernel on the card), held against
    the plain step from the same state: every map at its bar, tie flips
    of the locked step pinned by count where the plain step sits at a
    branch point, and depths clamped at the field of view's edge on one
    side only (FOV_TIES). ``gates`` (kernel's, plain's) receive the
    locked step's per-band gate decisions. Returns the new state and the
    pixels admitted, by kind (``lock_ties``'s, and "fov")."""
    a = step_args(cfg, kw)
    locked = "period" in a
    kernel, plain = ((kstep.dynamic_step_lock, kstep.dynamic_step_lock_ref)
                     if locked else (kstep.dynamic_step_open,
                                     kstep.dynamic_step_open_ref))
    args = (frame, state.strip_w, state.strip_b, state.proj_u, tables)
    got = kernel(*args, **a, **({"gates": gates[0]} if gates else {}))
    want = plain(*args, **a, **({"gates": gates[1]} if gates else {}))
    name = "dynamic_step_lock" if locked else "dynamic_step"
    ties, period, kinds = None, a.get("period", LOCK_T), {}
    if locked:
        lock = {k: a.pop(k) for k in ("period", "win_u", "win_v")}
        bar = BARS[name]["proj_u"]
        kinds = lock_ties(frame, kstep.dynamic_step_open_ref(*args, **a)[0],
                          got[0], lock, bar)
        ties = kinds["branch"] | kinds["gate"] | kinds["float64"]
        left = (got[0] - want[0]).abs() > bar
        for k, mask in kinds.items():       # each pixel by its first kind
            kinds[k] = int((left & mask).sum())
            left &= ~mask
    pinned = compare(name, got, want, STEP_OUT, errs,
                     flips=LOCK_FLIPS if locked else 0, quiet=True,
                     ties=ties, fov=(cfg.fov_min, cfg.fov_max),
                     period=period)
    kinds["fov"] = pinned - sum(kinds.values())
    return TrackerState(proj_u=got[0], strip_w=got[1], strip_b=got[2],
                        z=got[3], frame_idx=state.frame_idx + 1), kinds


def held_strips(state, frame, cfg, subpixel, errs):
    """A state's strips (the stripe kernel's, from init_tracker or
    reanchor) against the plain version on ``frame``."""
    compare("stripe", (state.strip_w, state.strip_b),
            kstripe.stripe_regression_ref(frame, cfg.reco_window, subpixel),
            ("strip_w", "strip_b"), errs, quiet=True)


def admitted(kinds):
    """The pixels held_step admitted past the bars, by kind."""
    n = sum(kinds.values())
    return ("no pixel past the bars" if not n else f"{n} pixels past the "
            f"bars admitted (" + ", ".join(f"{k} {v}" for k, v in
                                           sorted(kinds.items()) if v)
            + ")")


def phase_counts(want, what):
    """Require the launch counts since the last reset_counts() to be
    ``want`` (the other kernels 0); returns them."""
    got = read_counts()
    full = {k: 0 for k in WRAPPERS}
    full.update(want)
    log(f"{what} launches {got}")
    require(got == full, f"{what}: launch counts {got} != expected {full}")
    return got


def sequence_phase(dev, launches, errs):
    """Phase 8a: tests/test_sequence_100.py's 100 frames at the reference
    width through the kernels: reference semantics, the improved tracker,
    the locked one (21 x 9) and the improved one re-anchored every 25
    frames (an absolute decode through grayphase, the strips through
    stripe). Every step, decode and stripe map is held against its plain
    version from the same inputs; the drifts at frames 8 and 100 must
    meet the test's orderings and bars. Frames are rendered one at a time
    and only the compared ground truth is kept."""
    cfg = REFERENCE_CONFIG
    h, w = cfg.cam_h, cfg.cam_w
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    margin = cfg.reco_window // 2 + 2
    anchors = set(range(ANCHOR_EVERY, N_SEQ_FRAMES, ANCHOR_EVERY))
    states, drift = {}, {}
    flips = {name: collections.Counter() for name in SEQ_TRACKERS}
    render_s = 0.0
    reset_counts()
    t0 = time.perf_counter()
    frames = synth.iter_dynamic_sequence(
        calib, cfg, N_SEQ_FRAMES, z0=50.0, dz_per_frame=SEQ_DZ,
        stripe_period=int(LOCK_T), noise_sigma=1.0)
    for f in range(N_SEQ_FRAMES):
        r0 = time.perf_counter()
        frame, z_gt, pu = next(frames)
        render_s += time.perf_counter() - r0
        fd = torch.from_numpy(frame).to(dev)
        if f == 0:
            pu0 = torch.from_numpy(pu.astype(np.float32)).to(dev)
            z0 = torch.from_numpy(z_gt.astype(np.float32)).to(dev)
            for name, kw in SEQ_TRACKERS.items():
                sub = kw.get("subpixel", True)
                states[name] = init_tracker(fd, pu0, z0, cfg, sub)
                held_strips(states[name], fd, cfg, sub, errs)
            continue
        for name, kw in SEQ_TRACKERS.items():
            if name == "anchored" and f in anchors:
                r0 = time.perf_counter()
                asc = synth.render_static_scene(
                    calib, cfg, synth.plane_surface(50.0 + SEQ_DZ * f),
                    noise_sigma=1.0, seed=f)
                render_s += time.perf_counter() - r0
                g = torch.from_numpy(asc.gray_images).to(dev)
                p = torch.from_numpy(asc.phase_images).to(dev)
                dec = decode_first_frame(g, p, tables, cfg)
                compare("grayphase", (dec.x, dec.y, dec.z, dec.proj_u),
                        kgray.grayphase_decode_ref(g, p, tables, cfg),
                        ("x", "y", "z", "proj_u"), errs, quiet=True)
                states[name] = reanchor(states[name], fd, dec.proj_u,
                                        dec.z, cfg)
                held_strips(states[name], fd, cfg, True, errs)
                continue
            states[name], n = held_step(states[name], fd, tables, cfg, kw,
                                        errs)
            flips[name].update(n)
        if f in (8, N_SEQ_FRAMES - 1):
            for name, st in states.items():
                drift[name, f] = median_err(st.z.cpu().numpy(), z_gt,
                                            margin)
    n = N_SEQ_FRAMES - 1
    got = phase_counts({"grayphase": len(anchors),
                        "stripe": len(SEQ_TRACKERS) + len(anchors),
                        "dynamic_step_lock": n,
                        "dynamic_step": 3 * n - len(anchors)},
                       "phase 8a (100 frames)")
    for k, v in got.items():
        launches[k] += v
    last = N_SEQ_FRAMES - 1
    for name in SEQ_TRACKERS:
        log(f"phase 8a {name}: drift (median |z - z_gt|) at frame 8 "
            f"{drift[name, 8]:.5f}, at frame {last} {drift[name, last]:.5f}; "
            f"every step held against the plain step: "
            f"{admitted(flips[name])}")
    log(f"phase 8a: {N_SEQ_FRAMES} frames at {h}x{w} in "
        f"{time.perf_counter() - t0:.1f} s ({render_s:.1f} s rendering)")
    ref8, ref = drift["reference", 8], drift["reference", last]
    imp8, imp = drift["improved", 8], drift["improved", last]
    lock8, lock = drift["locked", 8], drift["locked", last]
    # tests/test_sequence_100.py's orderings and bars.
    for ok, what in (
            (ref8 > 2.0 * imp8, "reference drift at 8 > 2 x improved"),
            (imp < 2.0, "improved drift at 100 < 2.0"),
            (ref > 1.5 * imp, "reference drift at 100 > 1.5 x improved"),
            (ref < 6.0, "reference drift at 100 < 6.0"),
            (lock < 0.1, "locked drift at 100 < 0.1"),
            (lock < 0.1 * imp, "locked drift < 0.1 x improved"),
            (lock < 5.0 * max(lock8, 0.005), "locked drift not integrating"),
            (drift["anchored", last] < 0.5 * imp,
             "anchored drift < 0.5 x improved")):
        require(ok, f"phase 8a: {what} fails: {drift}")
    # The test's bars that slc_tpu itself misses at this width.
    for (name, f), (want, bar) in SLC_TPU_DRIFT.items():
        since = f - max([0] + [a for a in anchors if a <= f]) \
            if name == "anchored" else f
        lead = BARS["grayphase"]["z"] if since < f else 0.0
        tol = lead + since * BARS["dynamic_step"]["z"]
        got = drift[name, f]
        log(f"phase 8a {name} at frame {f}: drift {got:.5f}; the test's "
            f"bar < {bar} is missed by slc_tpu itself at {h}x{w} "
            f"({want:.5f}, tools/reference_drift.py): held to slc_tpu's "
            f"drift + {tol:.3f}")
        require(got <= want + tol, f"phase 8a: {name} drift at frame {f} "
                f"{got} above slc_tpu's {want} + {tol}")


def adversarial_frames(calib, cfg):
    """tests/test_demod_adversarial.py's scenes at ``cfg``, frame by frame:
    yields {scene: frame} with the frame's z_gt and P. One geometry per frame
    serves every scene; each scene has its own noise, seeded 0, as the
    test renders each."""
    def nonsinusoidal(pu):
        phi = 2.0 * np.pi * pu / LOCK_T
        raw = np.cos(phi) + 0.4 * np.cos(3 * phi)
        return np.clip((raw + 1.0) * 127.0, 0.0, 230.0)

    def clean(pu):
        return patterns.stripe_at(pu, LOCK_T)

    scenes = {"clean": (clean, 0.0), "nonsinusoidal": (nonsinusoidal, 0.0),
              "blur5": (clean, 5.0), "blur12": (clean, 12.0)}
    rngs = {name: np.random.default_rng(0) for name in scenes}
    for f in range(ADV_FRAMES):
        z, pu = synth.surface_geometry(calib, cfg, synth.plane_surface(
            50.0 + ADV_DZ * f))
        out = {}
        for name, (profile, sigma) in scenes.items():
            img = profile(pu)
            if sigma > 0:
                rad = int(np.ceil(3 * sigma))
                k = np.exp(-0.5 * (np.arange(-rad, rad + 1) / sigma) ** 2)
                img = np.apply_along_axis(
                    lambda r: np.convolve(r, k / k.sum(), mode="same"), 1,
                    img)
            img = img + rngs[name].normal(0.0, 1.0, img.shape)
            out[name] = np.clip(np.round(img), 0, 255).astype(np.uint8)
        yield out, z, pu


def adversarial_phase(dev, launches, errs):
    """Phase 8b: tests/test_demod_adversarial.py's scenes at the reference
    width through the locked and open-loop step kernels: clean, a
    non-sinusoidal carrier, the lock period x0.95 and x1.05 (on the clean
    frames), blur sigma 5, and blur sigma 12, which must gate the lock
    off. Every step is held against the plain step from the same state,
    and every locked step's per-band gate decisions against the plain
    step's (the gate is deterministic: they must be equal); the test's
    locked-against-free envelope holds on the last frame."""
    cfg = REFERENCE_CONFIG
    h, w = cfg.cam_h, cfg.cam_w
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    lock = dict(lock_win_u=21, lock_win_v=9)
    runs = {("clean", "locked"): dict(phase_lock=LOCK_T, **lock),
            ("clean", "x0.95"): dict(phase_lock=LOCK_T * 0.95, **lock),
            ("clean", "x1.05"): dict(phase_lock=LOCK_T * 1.05, **lock),
            ("clean", "free"): {},
            ("nonsinusoidal", "locked"): dict(phase_lock=LOCK_T, **lock),
            ("nonsinusoidal", "free"): {},
            ("blur5", "locked"): dict(phase_lock=LOCK_T, **lock),
            ("blur5", "free"): {},
            ("blur12", "locked"): dict(phase_lock=LOCK_T, **lock),
            ("blur12", "free"): {}}
    n_bands = -(-h // GATE_BAND)
    gates = (torch.empty(n_bands, device=dev),
             torch.empty(n_bands, device=dev))
    states, gated = {}, {}
    flips = {key: collections.Counter() for key in runs}
    reset_counts()
    t0 = time.perf_counter()
    scenes = adversarial_frames(calib, cfg)
    for f, (scene_frames, z_gt, pu) in enumerate(scenes):
        fd = {k: torch.from_numpy(v).to(dev) for k, v in scene_frames.items()}
        if f == 0:
            pu0 = torch.from_numpy(pu.astype(np.float32)).to(dev)
            z0 = torch.from_numpy(z_gt.astype(np.float32)).to(dev)
            for scene, run in runs:
                states[scene, run] = init_tracker(fd[scene], pu0, z0, cfg)
                held_strips(states[scene, run], fd[scene], cfg, True, errs)
            continue
        for (scene, run), kw in runs.items():
            locked = kw.get("phase_lock") is not None
            states[scene, run], n = held_step(
                states[scene, run], fd[scene], tables, cfg, kw, errs,
                gates if locked else None)
            flips[scene, run].update(n)
            if locked:
                k_off, p_off = (int((g == 0).sum()) for g in gates)
                require(torch.equal(gates[0], gates[1]),
                        f"phase 8b {scene} {run} frame {f}: kernel gates "
                        f"{gates[0].tolist()} != plain {gates[1].tolist()}")
                prev = gated.get((scene, run), (0, 0))
                gated[scene, run] = (prev[0] + k_off, prev[1] + p_off)
    steps = ADV_FRAMES - 1
    n_locked = sum(kw.get("phase_lock") is not None for kw in runs.values())
    got = phase_counts({"stripe": len(runs),
                        "dynamic_step_lock": n_locked * steps,
                        "dynamic_step": (len(runs) - n_locked) * steps},
                       "phase 8b (adversarial scenes)")
    for k, v in got.items():
        launches[k] += v
    margin = cfg.reco_window // 2 + 2
    z_last = {key: st.z.cpu().numpy() for key, st in states.items()}
    err = {key: median_err(z, z_gt, margin, min_valid=0.85)
           for key, z in z_last.items()}
    for key in runs:
        extra = ""
        if key in gated:
            extra = (f"; carrier gate off in {gated[key][0]} of "
                     f"{n_bands * steps} band-steps by the kernel, "
                     f"{gated[key][1]} by the plain step")
        log(f"phase 8b {key[0]} {key[1]}: median |z - z_gt| at frame "
            f"{ADV_FRAMES - 1} {err[key]:.5f}, {admitted(flips[key])}"
            f"{extra}")
    agree = float(np.isclose(z_last["blur12", "locked"],
                             z_last["blur12", "free"], atol=1e-3).mean())
    log(f"phase 8b: {len(runs)} runs of {ADV_FRAMES} frames at {h}x{w} in "
        f"{time.perf_counter() - t0:.1f} s; blur12 locked == free on "
        f"{agree:.4f} of the pixels")
    # tests/test_demod_adversarial.py's envelope.
    free = {s: err[s, "free"] for s in ("clean", "nonsinusoidal", "blur5")}
    for ok, what in (
            (err["clean", "locked"] < 0.05, "clean locked < 0.05"),
            (err["clean", "locked"] < free["clean"] + 0.02,
             "clean locked < free + 0.02"),
            (err["nonsinusoidal", "locked"]
             < max(1.5 * free["nonsinusoidal"], 0.08),
             "non-sinusoidal locked within 1.5 x free (or 0.08)"),
            (abs(err["clean", "x0.95"] - free["clean"]) < 0.02,
             "period x0.95 within 0.02 of free"),
            (abs(err["clean", "x1.05"] - free["clean"]) < 0.02,
             "period x1.05 within 0.02 of free"),
            (err["blur5", "locked"] < max(1.5 * free["blur5"], 0.15),
             "blur 5 locked within 1.5 x free (or 0.15)"),
            (agree > 0.9, "blur 12 locked == free on > 90% of pixels")):
        require(ok, f"phase 8b: {what} fails: {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-profiler", action="store_true",
                    help="time without torch.profiler (phase 4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.NVCC_FLAGS})")
    t0 = time.perf_counter()
    native_io.lib()
    log(f"build of the native I/O library: {time.perf_counter() - t0:.1f} s "
        f"({' '.join(native_io.FLAGS)}); host CPU {host_cpu()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    launches = {k: 0 for k in WRAPPERS}
    try:
        errs, inputs = {}, {}
        parity(dev, errs, inputs)
        # The device-timing path, counted like a run.
        reset_counts()
        times, expect, bounds, library, level_ms = timing(
            inputs, card, not args.no_profiler)
        got = read_counts()
        log(f"device-timing path launches {got}")
        require(got == expect, f"launch counts {got} != expected {expect}")
        for k, v in got.items():
            launches[k] += v
        del inputs
        run_errs = gray_runs(launches)
        stream_runs(launches, run_errs)
        capture_and_golden(launches)
        fringe_runs(dev, launches, level_ms)
        p2l_launches = fusion_phase()
        p2l_line = p2l_phase()
        p2l_launches += fuse_cli_run()
        parallel_phase(dev, launches)
        sequence_phase(dev, launches, errs)
        adversarial_phase(dev, launches, errs)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    meta = {
        "grayphase": ("grayphase.cu", "slc_tpu/pallas/grayphase.py:152"),
        "stripe": ("stripe.cu", "slc_tpu/pallas/stripe.py:102"),
        "dynamic_step_lock": ("dynamic_step.cu",
                              "slc_tpu/pallas/dynamic_lock.py:297"),
        "dynamic_step": ("dynamic_step.cu",
                         "slc_tpu/pallas/dynamic_step.py:166"),
        "heterodyne": ("heterodyne.cu", "slc_tpu/pallas/heterodyne.py:201"),
        "bilateral": ("bilateral.cu", "slc_tpu/pallas/bilateral.py:61"),
        "mg_down": ("mgsmooth.cu", "slc_tpu/pallas/mgsmooth.py:149"),
        "mg_up": ("mgsmooth.cu", "slc_tpu/pallas/mgsmooth.py:178"),
        "mg_coarse": ("mgsmooth.cu", "port-only"),
        "phase_lock": ("dynamic_step.cu", "slc_tpu/pallas/phaselock.py:216"),
        "halo_block_floor": ("floors.cu", "slc_tpu/pallas/floors.py:25"),
        "lock_window": ("lock_window.cu", "port-only"),
    }
    # The floor's line carries the stripe pattern's times. No single
    # PyTorch call computes the other kernels' functions: their
    # library_ms is null.
    times["halo_block_floor"] = times["floor_stripe"]
    bounds["halo_block_floor"] = bounds["floor_stripe"]
    library["halo_block_floor"] = library["floor_stripe"]
    kernels = [{"name": name, "route": "cuda",
                "source": f"slc_tpu_torch/kernels/csrc/{src}",
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": library.get(name),
                "kernel_only_ms": times[name][2]}
               for name, (src, rep) in meta.items()]
    for k in kernels:
        plain_alone = times[k["name"]][3]
        if plain_alone is not None:
            k["plain_kernel_only_ms"] = plain_alone
    p2l_line["launches"] = p2l_launches
    kernels.append(p2l_line)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
