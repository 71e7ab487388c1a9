#!/usr/bin/env python3
"""Compare the stripe, tracking-step, lock, multigrid, heterodyne and
bilateral launches of this checkout's kernel library with those of another
checkout of slc_tpu_torch, on one CUDA card.

    python3 tools/compare_lock_builds.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is the root of another tree of the repo (for example
the parent commit, unpacked with ``git archive``); its kernels are built
from its own ``slc_tpu_torch/kernels/csrc`` into its own build directory.
Both libraries are driven through this checkout's wrappers (their C
interface is the same), at chip_smoke.py's two shapes, 1024x1280 and
1000x1270:

1. bit for bit: the stripe regression's two maps at windows 5, 21 and
   63, ``subpixel`` on and off, ``frac_bits`` 0 and 7, on a random frame
   and a rendered one; the open-loop step's six maps and the locked step's
   six, at stripe windows 5, 21 and 63, ``subpixel`` on and off,
   ``frac_bits`` 0 and 7, ``scale_gradient`` and ``robust`` each on and
   off (the locked step at the suggested lock window, gate on); the
   locked step (``frac_bits`` 0 and 7) and the standalone lock on the
   open-loop step's P with a hole band, at the suggested lock window and
   at windows (3, 3) and (63, 63), with the gate on and off; ``mg_down``'s
   two maps and ``mg_up``'s one on random levels (chip_smoke.py's
   ``mg_level``) at the three multigrid level shapes of each shape's
   chain (1024x1280, 512x640, 256x320; 1000x1270, 500x635, 250x318); the
   heterodyne decode's four maps, ``min_modulation`` 2.0 and None, at the
   reference's 3 frequencies x 4 steps and at HETS' other (F, N) (the
   kernel's generic instance), on a rendered fringe stack
   (``synth.render_fringe_stack``) and a random u8 one; the bilateral
   filter at both shapes and at 97x157, 1x1280 and 1024x1, on random depth
   with 0%, 10% and 50% holes, a map with -0.0 entries and one with
   isolated +-inf and NaN, and, at 1024x1280, on the spatial decode's
   unfiltered z at the reference config; every output map must be equal
   bit for bit, NaN at the same pixels;
2. the kernels-alone device time (``devtime.graph_time_s``, 20 calls in
   one CUDA graph) of, at 1024x1280, the stripe regression (window 21,
   sub-pixel), the open-loop step, the locked step's track launch
   (``ablate="track"``), the step up to the lock's DC (``ablate="dc"``),
   the locked step, the standalone lock and the heterodyne decode (3 x 4),
   the last also cold (inputs and outputs rotated over COLD_SETS sets,
   ``devtime.rotating``); of the bilateral filter (the 10%-hole map) at
   both shapes, and cold at 1024x1280; of ``mg_down`` and ``mg_up`` at
   each level shape, and both cold at 1024x1280; the two libraries in
   turns (other, this, this, other).

``--only WORD[,WORD...]`` keeps the cases and timed lines whose name
holds one of the words (``--only heterodyne,mg_down``, ``--only
bilateral``), to time a variant of one kernel. Exits non-zero if any map
differs.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import itertools
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import level_chain, mg_level  # noqa: E402
from slc_tpu_torch import devtime, synth  # noqa: E402
from slc_tpu_torch.calib import build_tables, synthetic_calibration  # noqa
from slc_tpu_torch.config import REFERENCE_CONFIG, HeterodyneConfig  # noqa
from slc_tpu_torch.kernels import _build  # noqa: E402
from slc_tpu_torch.kernels import bilateral as kbil  # noqa: E402
from slc_tpu_torch.kernels import dynamic_step as kstep  # noqa: E402
from slc_tpu_torch.kernels import heterodyne as khet  # noqa: E402
from slc_tpu_torch.kernels import mgsmooth as kmg  # noqa: E402
from slc_tpu_torch.kernels import phaselock as kpl  # noqa: E402
from slc_tpu_torch.kernels import stripe as kstripe  # noqa: E402
from slc_tpu_torch.ops.demod import suggest_lock_window  # noqa: E402
from slc_tpu_torch.pipeline import decode_spatial_frame  # noqa: E402

SHAPES = ((1024, 1280), (1000, 1270))
LOCK_T = 12.0
#: Input sets of the cold timings: 24 B/px for the multigrid kernels
#: (~189 MB in all at 1024x1280), 28 B/px for heterodyne (~220 MB).
COLD_SETS = 6
#: Heterodyne configurations: the reference's 3 frequencies x 4 steps, and
#: two that take the kernel's generic instance.
HETS = {"3 x 4": HeterodyneConfig(),
        "3 x 5": HeterodyneConfig(phase_steps=5),
        "4 x 4": HeterodyneConfig(fringe_counts=(64, 58, 55, 54))}
#: Shapes the bilateral filter is also held at: an odd one, one row, one
#: column.
BILATERAL_SHAPES = ((97, 157), (1, 1280), (1024, 1))


def depth_maps(h, w, dev, seed=0):
    """The bilateral filter's random inputs at (h, w): depth 50 +- 0.4
    with 0%, 10% and 50% holes, with 10% -0.0 entries, and with isolated
    +-inf and NaN (1 in 500 each)."""
    rng = np.random.default_rng(seed)
    base = (50.0 + rng.normal(0, 0.4, (h, w))).astype(np.float32)
    maps = {}
    for frac in (0.0, 0.1, 0.5):
        z = base.copy()
        z[rng.uniform(size=(h, w)) < frac] = 0.0
        maps[f"{frac:.0%} holes"] = z
    z = base.copy()
    z[rng.uniform(size=(h, w)) < 0.1] = -0.0
    maps["-0.0 entries"] = z
    z = base.copy()
    for val in (np.inf, -np.inf, np.nan):
        z.ravel()[rng.integers(0, h * w, max(1, h * w // 500))] = val
    maps["+-inf and NaN"] = z
    return {k: torch.from_numpy(v).to(dev) for k, v in maps.items()}


def bits_equal(x, y) -> bool:
    """Equal bit for bit, NaN (any payload) at the same pixels."""
    if x.dtype != torch.float32:
        return torch.equal(x, y)
    nan = torch.isnan(x)
    return torch.equal(nan, torch.isnan(y)) and torch.equal(
        x.view(torch.int32)[~nan], y.view(torch.int32)[~nan])


def other_library(root: str):
    """The kernel library of the checkout at ``root``, built by that
    checkout's own ``_build`` module."""
    path = os.path.join(root, "slc_tpu_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def using(lib, fn):
    """``fn`` with this checkout's wrappers calling ``lib``."""
    def call():
        saved, _build._lib = _build._lib, lib
        try:
            return fn()
        finally:
            _build._lib = saved
    return call


def same_maps(libs, tag, fn):
    """Run ``fn`` on both libraries and print which output maps differ;
    returns (maps, maps that differ)."""
    a = using(libs["other"], fn)()
    b = using(libs["this"], fn)()
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if not bits_equal(x, y)]
    print(f"{tag}: " + ("bit-identical" if not diff else f"DIFFER in maps "
                       f"{diff}, max|diff| " + ", ".join(
                           f"{float((a[i] - b[i]).abs().max()):.3e}"
                           for i in diff)), flush=True)
    return len(a), len(diff)


def time_turns(libs, tag, fn):
    """The kernels-alone device time of ``fn`` with each library, in
    turns (other, this, this, other)."""
    t = {k: [] for k in libs}
    for k in ("other", "this", "this", "other"):
        t[k].append(1e3 * devtime.graph_time_s(using(libs[k], fn)))
    print(f"time {tag}, kernels alone (graph of 20), this vs other: "
          f"{sum(t['this']) / 2:.4f} ms ({t['this'][0]:.4f}, "
          f"{t['this'][1]:.4f}) vs {sum(t['other']) / 2:.4f} ms "
          f"({t['other'][0]:.4f}, {t['other'][1]:.4f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--only", default="",
                    help="comma-separated words: keep the cases and timed "
                         "lines whose name holds one")
    args = ap.parse_args(argv)
    words = [x for x in args.only.split(",") if x]

    def wanted(name):
        return not words or any(x in name for x in words)

    if not torch.cuda.is_available():
        print("compare_lock_builds: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"this": _build.lib(), "other": other_library(args.other)}
    n_maps = n_diff = 0
    for h, w in SHAPES:
        cfg = dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)
        calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                      pro_w=cfg.pro_w)
        tables = build_tables(calib, h, w, dev)
        frames, _, pu_gt = synth.render_dynamic_sequence(
            calib, cfg, 2, z0=50.0, dz_per_frame=0.3,
            stripe_period=int(LOCK_T), noise_sigma=1.0)
        f0, f1 = (torch.from_numpy(f).to(dev) for f in frames)
        pu0 = torch.from_numpy(pu_gt[0].astype(np.float32)).to(dev)
        sw0, sb0 = kstripe.stripe_regression_ref(f0, cfg.reco_window)
        step_args = (f1, sw0, sb0, pu0, tables)
        kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
                  fov_max=cfg.fov_max)
        pred = kstep.dynamic_step_open_cuda(*step_args, **kw)[0].clone()
        pred[:, 40:48] = 0.0
        win = suggest_lock_window(pu_gt[0], LOCK_T)
        cases = {}
        for window, sub, frac, sg, rb in itertools.product(
                (5, 21, 63), (True, False), (0, 7), (True, False),
                (True, False)):
            tk = dict(window=window, subpixel=sub, frac_bits=frac,
                      scale_gradient=sg, robust=rb, fov_min=cfg.fov_min,
                      fov_max=cfg.fov_max)
            tag = (f"window {window} subpixel {sub:d} frac {frac} scale "
                   f"{sg:d} robust {rb:d}")
            cases[f"open-loop step {tag}"] = (
                lambda tk=tk: kstep.dynamic_step_open_cuda(*step_args, **tk))
            cases[f"locked step {tag}"] = (
                lambda tk=tk: kstep.dynamic_step_lock_cuda(
                    *step_args, **tk, period=LOCK_T, win_u=win, win_v=9))
        for wu, wv in sorted({(win, 9), (3, 3), (63, 63)}):
            for thresh in (2e-3, 0.0):
                lk = dict(period=LOCK_T, win_u=wu, win_v=wv,
                          max_carrier_gradient=thresh)
                for frac in (0, 7):
                    cases[f"step win ({wu}, {wv}) gate {thresh:g} frac "
                          f"{frac}"] = (
                        lambda lk=lk, frac=frac: kstep.dynamic_step_lock_cuda(
                            *step_args, **kw, **lk, frac_bits=frac))
                cases[f"lock win ({wu}, {wv}) gate {thresh:g}"] = (
                    lambda lk=lk: kpl.phase_lock_cuda(
                        f1, pred, tables, **lk, fov_min=cfg.fov_min,
                        fov_max=cfg.fov_max))
        rand = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (h, w), np.uint8)).to(dev)
        for (fname, frame), window, sub, frac in itertools.product(
                (("random", rand), ("rendered", f1)), (5, 21, 63),
                (True, False), (0, 7)):
            cases[f"stripe {fname} frame window {window} subpixel {sub:d} "
                  f"frac {frac}"] = (
                lambda a=(frame, window, sub, frac):
                    kstripe.stripe_regression_cuda(*a))
        for (hname, het), (sname, rendered) in itertools.product(
                HETS.items(), (("rendered", True), ("random", False))):
            stack = synth.render_fringe_stack(
                calib, cfg, synth.sphere_surface(), het.periods(cfg.pro_w),
                het.phase_steps, noise_sigma=1.0)[0] if rendered else \
                np.random.default_rng(1).integers(
                    0, 256, (het.num_images, h, w), np.uint8)
            stack = torch.from_numpy(stack).to(dev)
            for mm in (2.0, None):
                cases[f"heterodyne {hname} {sname} stack min_modulation "
                      f"{mm}"] = (
                    lambda a=(stack, tables, cfg, het, mm):
                        khet.heterodyne_decode_cuda(*a))
        levels = {}
        for lh, lw in level_chain(h, w):
            lv = levels[(lh, lw)] = mg_level(dev, lh, lw)
            r, e, wy, wx, dinv = lv
            cases[f"mg_down level {lh}x{lw}"] = (
                lambda a=(r, wy, wx, dinv): kmg.mg_down_cuda(*a))
            cases[f"mg_up level {lh}x{lw}"] = (
                lambda a=(e, r, wy, wx, dinv): (kmg.mg_up_cuda(*a),))
        depth = depth_maps(h, w, dev)
        for dname, z in depth.items():
            cases[f"bilateral {dname}"] = (
                lambda z=z: (kbil.bilateral_filter_cuda(z),))
        if (h, w) == SHAPES[0] and wanted("bilateral"):
            scene = synth.render_static_scene(
                calib, cfg, synth.plane_surface(50.0), noise_sigma=1.0)
            spatial_z = decode_spatial_frame(
                torch.from_numpy(scene.phase_images).to(dev), tables, cfg,
                float(cfg.phase_period), filter_depth=False).z
            cases["bilateral spatial decode z (reference config)"] = (
                lambda: (kbil.bilateral_filter_cuda(spatial_z),))
        for name, fn in cases.items():
            if not wanted(name):
                continue
            n, d = same_maps(libs, f"{h}x{w} {name}", fn)
            n_maps += n
            n_diff += d
        if wanted("bilateral"):
            z = depth["10% holes"]
            time_turns(libs, f"bilateral at {h}x{w}",
                       lambda: kbil.bilateral_filter_cuda(z))
            if (h, w) == SHAPES[0]:
                sets = [z.clone() for _ in range(COLD_SETS)]
                time_turns(libs, f"bilateral cold ({COLD_SETS} input sets "
                           f"rotated) at {h}x{w}",
                           devtime.rotating(kbil.bilateral_filter_cuda,
                                            sets))
                del sets
        if (h, w) == SHAPES[0]:
            lk = dict(period=LOCK_T, win_u=win, win_v=9)
            timed = {
                "stripe (window 21, subpixel)":
                    lambda: kstripe.stripe_regression_cuda(f1, 21),
                "open-loop step": lambda: kstep.dynamic_step_open_cuda(
                    *step_args, **kw),
                "track launch (ablate track)":
                    lambda: kstep.dynamic_step_lock_cuda(
                        *step_args, **kw, **lk, ablate="track"),
                "locked step": lambda: kstep.dynamic_step_lock_cuda(
                    *step_args, **kw, **lk),
                "locked step to DC": lambda: kstep.dynamic_step_lock_cuda(
                    *step_args, **kw, **lk, ablate="dc"),
                "standalone lock": lambda: kpl.phase_lock_cuda(
                    f1, pred, tables, **lk, fov_min=cfg.fov_min,
                    fov_max=cfg.fov_max)}
            fringes = torch.from_numpy(synth.render_fringe_stack(
                calib, cfg, synth.sphere_surface(),
                HETS["3 x 4"].periods(cfg.pro_w), 4, noise_sigma=1.0)[0]
            ).to(dev)
            timed["heterodyne (3 x 4)"] = lambda: khet.heterodyne_decode_cuda(
                fringes, tables, cfg, HETS["3 x 4"])
            for name, fn in timed.items():
                if wanted(name):
                    time_turns(libs, f"{name} at {h}x{w}", fn)
            if wanted("heterodyne (3 x 4) cold"):
                sets = [fringes.clone() for _ in range(COLD_SETS)]
                time_turns(libs, f"heterodyne (3 x 4) cold ({COLD_SETS} "
                           f"input sets rotated) at {h}x{w}",
                           devtime.rotating(
                               lambda a: khet.heterodyne_decode_cuda(
                                   a, tables, cfg, HETS["3 x 4"]), sets))
                del sets
        for (lh, lw), (r, e, wy, wx, dinv) in levels.items():
            if wanted("mg_down"):
                time_turns(libs, f"mg_down at {lh}x{lw}",
                           lambda a=(r, wy, wx, dinv): kmg.mg_down_cuda(*a))
            if wanted("mg_up"):
                time_turns(libs, f"mg_up at {lh}x{lw}",
                           lambda a=(e, r, wy, wx, dinv): kmg.mg_up_cuda(*a))
            if (lh, lw) == SHAPES[0]:
                sets = [tuple(x.clone() for x in (e, r, wy, wx, dinv))
                        for _ in range(COLD_SETS)]
                if wanted("mg_down"):
                    time_turns(libs, f"mg_down cold ({COLD_SETS} input sets "
                               f"rotated) at {lh}x{lw}",
                               devtime.rotating(lambda a: kmg.mg_down_cuda(
                                   *a[1:]), sets))
                if wanted("mg_up"):
                    time_turns(libs, f"mg_up cold ({COLD_SETS} input sets "
                               f"rotated) at {lh}x{lw}",
                               devtime.rotating(lambda a: kmg.mg_up_cuda(*a),
                                                sets))
                del sets
    for h, w in BILATERAL_SHAPES if wanted("bilateral") else ():
        for dname, z in depth_maps(h, w, dev).items():
            n, d = same_maps(libs, f"{h}x{w} bilateral {dname}",
                             lambda z=z: (kbil.bilateral_filter_cuda(z),))
            n_maps += n
            n_diff += d
    print(f"{n_maps - n_diff} of {n_maps} maps bit-identical on {card}")
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
