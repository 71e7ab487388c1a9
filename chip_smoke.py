#!/usr/bin/env python3
"""Smoke test of slc_tpu_torch on one CUDA card: build, kernel parity,
kernel timing, and the replay main path end to end.

    python3 chip_smoke.py

Run from the root of a checkout. In order it:

1. requires CUDA and prints the card (``nvidia-smi``), torch and CUDA;
2. builds the four CUDA kernels from ``slc_tpu_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version, both on the card,
   at the reference shape 1024x1280 and a ragged 1000x1270, on rendered
   inputs (and a random frame for the stripe kernel), at the bars of the
   CPU parity tests;
4. times each kernel and its plain version at 1024x1280 with CUDA events
   (median of 25 calls after warm-up);
5. renders a 30-frame moving-plane dataset at the reference config and
   runs ``python -m slc_tpu_torch run`` on it through ``main()``, with the
   phase lock on and off: every kernel's launch count must equal the calls
   the runner makes, and the locked depth error at the last frame must be
   below 0.05 scene units and below half the free-running error.

Any failure ends the script with a non-zero exit. The last line of its
output is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

from slc_tpu_torch import synth
from slc_tpu_torch.__main__ import main as slc_main
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import REFERENCE_CONFIG
from slc_tpu_torch.io.dataset import write_replay_dataset
from slc_tpu_torch.io.opencv_yaml import save_calibration
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import grayphase as kgray
from slc_tpu_torch.kernels import stripe as kstripe
from slc_tpu_torch.ops.demod import suggest_lock_window

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke_work")
SHAPES = ((1024, 1280), (1000, 1270))
N_FRAMES = 30
LOCK_T = 12.0

# Bars (tests/test_torch_*.py): decode P 2e-3, x/y/z 8e-3; strips 1e-5;
# locked step P 2e-3, z/x 4e-3; open-loop P 2e-4, z 2e-3, x 2e-4.
BARS = {
    "grayphase": {"proj_u": 2e-3, "x": 8e-3, "y": 8e-3, "z": 8e-3},
    "stripe": {"strip_w": 1e-5, "strip_b": 1e-5},
    "dynamic_step_lock": {"proj_u": 2e-3, "strip_w": 1e-5,
                          "strip_b": 1e-5, "z": 4e-3, "x": 4e-3,
                          "y": 4e-3},
    "dynamic_step": {"proj_u": 2e-4, "strip_w": 1e-5, "strip_b": 1e-5,
                     "z": 2e-3, "x": 2e-4, "y": 2e-4},
}
STEP_OUT = ("proj_u", "strip_w", "strip_b", "z", "x", "y")
#: The locked step's per-pixel arccos refinement takes, of the two
#: readings +-phi, the one nearer the window-corrected prediction
#: (slc_tpu/ops/demod.py:194-201). Where both are equally near, float
#: rounding picks either, and P may move by up to T/2 at that pixel.
#: Such isolated flips are pinned by count per comparison at 1.3 MP, as
#: slc_tpu pins heterodyne beat-order flips (tests/conftest.py:41-64).
LOCK_FLIPS = 32


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


def compare(name, got, want, keys, errs, flips=0):
    """Assert each output within its bar; record the max abs error.

    ``flips`` > 0 pins that many isolated branch flips of proj_u (see
    LOCK_FLIPS): each may move P by at most T/2, no 2x2 block may flip
    together, and the maps derived from P (z, x, y) are compared on the
    other pixels only."""
    agree = None
    for k, g, e in zip(keys, got, want):
        d = (g - e).abs()
        if agree is not None and k in ("z", "x", "y"):
            d = torch.where(agree, d, torch.zeros_like(d))
        finite = bool(torch.isfinite(g).all() and torch.isfinite(e).all())
        err = float(d.max())
        bar = BARS[name][k]
        over = d > bar
        n_over = int(over.sum())
        log(f"  {name}.{k}: max|diff| {err:.3e} (bar {bar:g}, "
            f"{n_over} px over)")
        require(finite, f"{name}.{k}: non-finite values")
        if flips and k == "proj_u" and n_over:
            idx = over.nonzero().tolist()
            log(f"  {name}.proj_u flips at (row, col, kernel, plain): "
                + ", ".join(f"({r}, {c}, {float(g[r, c]):.4f}, "
                            f"{float(e[r, c]):.4f})" for r, c in idx[:16]))
            block = over[:-1, :-1] & over[1:, :-1] & over[:-1, 1:] \
                & over[1:, 1:]
            require(n_over <= flips,
                    f"{name}.proj_u: {n_over} flips (pinned at {flips})")
            require(err <= LOCK_T / 2 + bar,
                    f"{name}.proj_u: a flip moved P by {err} > T/2")
            require(not bool(block.any()),
                    f"{name}.proj_u: a 2x2 block flipped together")
            agree = ~over
            errs[f"{name}_flips"] = errs.get(f"{name}_flips", 0) + n_over
            err = float(torch.where(agree, d, torch.zeros_like(d)).max())
        else:
            require(n_over == 0,
                    f"{name}.{k}: {n_over} px over the bar {bar}")
        errs[name] = max(errs.get(name, 0.0), err)


def cfg_for(h, w):
    return dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)


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

        frames, z_gt, pu_gt = synth.render_dynamic_sequence(
            calib, cfg, 2, z0=50.0, dz_per_frame=0.3,
            stripe_period=int(LOCK_T), noise_sigma=1.0)
        rand = np.random.default_rng(0).integers(0, 256, (h, w), np.uint8)
        for frame in (rand, frames[1]):
            f = torch.from_numpy(frame).to(dev)
            for sub in (True, False):
                compare("stripe", kstripe.stripe_regression_cuda(f, 21, sub),
                        kstripe.stripe_regression_ref(f, 21, sub),
                        ("strip_w", "strip_b"), errs)

        f0 = torch.from_numpy(frames[0]).to(dev)
        f1 = torch.from_numpy(frames[1]).to(dev)
        pu0 = torch.from_numpy(pu_gt[0].astype(np.float32)).to(dev)
        sw0, sb0 = kstripe.stripe_regression_ref(f0, cfg.reco_window, True)
        win = suggest_lock_window(pu_gt[0], LOCK_T)
        log(f"  suggested lock window {win}")
        args = (f1, sw0, sb0, pu0, tables)
        for ref in (False, True):
            kw = dict(window=cfg.reco_window, subpixel=not ref,
                      scale_gradient=not ref, robust=not ref,
                      fov_min=cfg.fov_min, fov_max=cfg.fov_max)
            compare("dynamic_step", kstep.dynamic_step_open_cuda(*args, **kw),
                    kstep.dynamic_step_open_ref(*args, **kw), STEP_OUT, errs)
            for win_u in sorted({21, win}):
                lk = dict(kw, period=LOCK_T, win_u=win_u, win_v=9)
                compare("dynamic_step_lock",
                        kstep.dynamic_step_lock_cuda(*args, **lk),
                        kstep.dynamic_step_lock_ref(*args, **lk), STEP_OUT,
                        errs, flips=LOCK_FLIPS)
        if (h, w) == SHAPES[0]:
            inputs.update(g=g, p=p, tables=tables, cfg=cfg, frame=f1,
                          step_args=args, win=win)


def time_call(fn, runs=25, warmup=3):
    """Median ms per call between CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def timing(inputs):
    """Phase 4: kernel vs plain version at 1024x1280."""
    g, p, tables, cfg = (inputs[k] for k in ("g", "p", "tables", "cfg"))
    args = inputs["step_args"]
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    lk = dict(kw, period=LOCK_T, win_u=inputs["win"], win_v=9)
    pairs = {
        "grayphase": (
            lambda: kgray.grayphase_decode_cuda(g, p, tables, cfg),
            lambda: kgray.grayphase_decode_ref(g, p, tables, cfg)),
        "stripe": (
            lambda: kstripe.stripe_regression_cuda(inputs["frame"], 21),
            lambda: kstripe.stripe_regression_ref(inputs["frame"], 21)),
        "dynamic_step_lock": (
            lambda: kstep.dynamic_step_lock_cuda(*args, **lk),
            lambda: kstep.dynamic_step_lock_ref(*args, **lk)),
        "dynamic_step": (
            lambda: kstep.dynamic_step_open_cuda(*args, **kw),
            lambda: kstep.dynamic_step_open_ref(*args, **kw)),
    }
    out = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: the median of each pair's two.
        t_p1 = time_call(plain)
        t_k1 = time_call(kern)
        t_k2 = time_call(kern)
        t_p2 = time_call(plain)
        out[name] = ((t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2)
        log(f"time {name} at 1024x1280: kernel {out[name][0]:.4f} ms "
            f"({t_k1:.4f}, {t_k2:.4f}), plain {out[name][1]:.4f} ms "
            f"({t_p1:.4f}, {t_p2:.4f})")
    return out


def end_to_end():
    """Phase 5: the replay main path through the CLI, lock on and off.
    Returns the launch counts of the two runs together."""
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
    log(f"e2e: rendered and wrote {N_FRAMES} frames at "
        f"{cfg.cam_h}x{cfg.cam_w} in {time.perf_counter() - t0:.1f} s")

    # Per run the runner decodes frame 0 twice (a warm-up, then the
    # timed decode), tracks frame 0 once (init_tracker) and steps once
    # for its warm-up plus once per remaining frame.
    per_run = {"grayphase": 2, "stripe": 1, "step": 1 + (N_FRAMES - 1)}
    expected = {"grayphase": 2 * per_run["grayphase"],
                "stripe": 2 * per_run["stripe"],
                "dynamic_step_lock": per_run["step"],
                "dynamic_step": per_run["step"]}
    log(f"e2e: expected launches {expected}")
    reset_counts()
    errs = {}
    for name, extra in (("locked", []), ("free", ["--phase-lock", "off"])):
        out = os.path.join(WORK, name)
        rc = slc_main(["run", ds, "--calib",
                       os.path.join(ds, "parameters.yml"), "--out", out,
                       "--out-format", "npz", "--device", "cuda", *extra])
        require(rc == 0, f"run {name} exited {rc}")
        z = np.load(os.path.join(out, f"cFrame{N_FRAMES - 1}.npz"))["z"]
        r = cfg.reco_window // 2 + 2
        zi, gi = z[r:-r, r:-r], zs[N_FRAMES - 1][r:-r, r:-r]
        v = zi > 0
        require(np.isfinite(z).all() and v.mean() > 0.9,
                f"{name}: depth not finite or mostly invalid")
        errs[name] = float(np.median(np.abs(zi[v] - gi[v])))
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        frames_r = [x for x in recs if "frame" in x]
        require(len(frames_r) == N_FRAMES, f"{name}: {len(frames_r)} records")
        steps = [x["t_dynamic_step_ms"] for x in frames_r[1:]]
        fps = [x["fps"] for x in frames_r[2:]]
        log(f"e2e {name}: median|z err| at frame {N_FRAMES - 1} "
            f"{errs[name]:.5f}, valid_frac {frames_r[-1]['valid_frac']:.4f}, "
            f"step median {statistics.median(steps):.3f} ms, "
            f"fps median {statistics.median(fps):.1f}, "
            f"decode {frames_r[0]['t_first_frame_ms']:.3f} ms")
        log(f"e2e {name}: launches so far {counts()}")
    got = counts()
    require(got == expected, f"launch counts {got} != expected {expected}")
    require(errs["locked"] < 0.05, f"locked error too large: {errs}")
    require(errs["locked"] < 0.5 * errs["free"],
            f"locked error not below half the free-running one: {errs}")
    return got


#: The kernel wrappers, each with its ``launches`` count.
WRAPPERS = {"grayphase": kgray.grayphase_decode_cuda,
            "stripe": kstripe.stripe_regression_cuda,
            "dynamic_step_lock": kstep.dynamic_step_lock_cuda,
            "dynamic_step": kstep.dynamic_step_open_cuda}


def counts():
    return {k: w.launches for k, w in WRAPPERS.items()}


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.NVCC_FLAGS})")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        errs, inputs = {}, {}
        parity(dev, errs, inputs)
        times = timing(inputs)
        del inputs
        launches = end_to_end()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    meta = {
        "grayphase": ("slc_tpu_torch/kernels/csrc/grayphase.cu",
                      "slc_tpu/pallas/grayphase.py:152"),
        "stripe": ("slc_tpu_torch/kernels/csrc/stripe.cu",
                   "slc_tpu/pallas/stripe.py:102"),
        "dynamic_step_lock": ("slc_tpu_torch/kernels/csrc/dynamic_step.cu",
                              "slc_tpu/pallas/dynamic_lock.py:297"),
        "dynamic_step": ("slc_tpu_torch/kernels/csrc/dynamic_step.cu",
                         "slc_tpu/pallas/dynamic_step.py:166"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
