#!/usr/bin/env python3
"""slc_tpu's own drifts on chip_smoke.py phase 8a's scene, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/reference_drift.py [--port]

Runs tests/test_sequence_100.py's four trackers with slc_tpu (JAX, XLA
path) at the reference config (1024x1280, stripe period 12, noise 1,
the plane moving 0.08 a frame for 100 frames; anchors at frames 25, 50
and 75 for the re-anchored run) and prints the median |z - z_gt| on the
interior at frames 8 and 99, beside the test's bars. These are the
values chip_smoke.py phase 8a holds the kernels' drifts against where
slc_tpu itself misses a bar of the test at this width
(``chip_smoke.SLC_TPU_DRIFT``). ``--port`` runs slc_tpu_torch's plain
path on the same frames too (several minutes on the CPU). Frames are
rendered one at a time; nothing of the sequence is held. This tool
compares the two packages, so it imports both; the port never does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_FRAMES, DZ, ANCHOR_EVERY, T = 100, 0.08, 25, 12.0
TRACKERS = {
    "reference": dict(scale_gradient=False, subpixel=False, robust=False),
    "improved": {},
    "locked": dict(phase_lock=T, lock_win_u=21, lock_win_v=9),
    "anchored": {},
}


def drift(z, z_gt, margin):
    zi, gi = z[margin:-margin, margin:-margin], z_gt[margin:-margin,
                                                     margin:-margin]
    v = zi > 0
    return float(np.median(np.abs(zi[v] - gi[v])))


def run(pkg):
    """The four trackers' drifts {(name, frame): median} with ``pkg``
    ("jax" or "torch", the latter on the CPU)."""
    from slc_tpu_torch import synth
    from slc_tpu_torch.config import REFERENCE_CONFIG as cfg
    if pkg == "jax":
        import jax.numpy as jnp
        from slc_tpu.calib import build_tables, synthetic_calibration
        from slc_tpu.dynamic import dynamic_step, init_tracker, reanchor
        from slc_tpu.pipeline import decode_first_frame

        def arr(a, f32=False):
            return jnp.asarray(a, jnp.float32) if f32 else jnp.asarray(a)
        calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                      pro_h=cfg.pro_h, pro_w=cfg.pro_w)
        tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
        kw0 = dict(use_pallas=False)
    else:
        import torch
        from slc_tpu_torch.calib import build_tables, synthetic_calibration
        from slc_tpu_torch.dynamic import (dynamic_step, init_tracker,
                                           reanchor)
        from slc_tpu_torch.pipeline import decode_first_frame

        def arr(a, f32=False):
            return torch.from_numpy(np.asarray(a, np.float32) if f32
                                    else np.ascontiguousarray(a))
        calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                      pro_h=cfg.pro_h, pro_w=cfg.pro_w)
        tables = build_tables(calib, cfg.cam_h, cfg.cam_w, device="cpu")
        kw0 = {}
    margin = cfg.reco_window // 2 + 2
    anchors = set(range(ANCHOR_EVERY, N_FRAMES, ANCHOR_EVERY))
    states, out = {}, {}
    frames = synth.iter_dynamic_sequence(
        calib, cfg, N_FRAMES, z0=50.0, dz_per_frame=DZ, stripe_period=12,
        noise_sigma=1.0)
    for f, (frame, z_gt, pu) in enumerate(frames):
        fr = arr(frame)
        for name, kw in TRACKERS.items():
            sub = kw.get("subpixel", True)
            if f == 0:
                states[name] = init_tracker(fr, arr(pu, True),
                                            arr(z_gt, True), cfg, sub, **kw0)
            elif name == "anchored" and f in anchors:
                asc = synth.render_static_scene(
                    calib, cfg, synth.plane_surface(50.0 + DZ * f),
                    noise_sigma=1.0, seed=f)
                dec = decode_first_frame(arr(asc.gray_images),
                                         arr(asc.phase_images), tables, cfg)
                states[name] = reanchor(states[name], fr, dec.proj_u, dec.z,
                                        cfg, **kw0)
            else:
                states[name], _ = dynamic_step(states[name], fr, tables,
                                               cfg, **kw, **kw0)
            if f in (8, N_FRAMES - 1):
                out[name, f] = drift(np.asarray(states[name].z), z_gt,
                                     margin)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", action="store_true",
                    help="also run slc_tpu_torch's plain path")
    args = ap.parse_args(argv)
    results = {"slc_tpu": run("jax")}
    if args.port:
        results["slc_tpu_torch (plain, CPU)"] = run("torch")
    bars = {("improved", 8): "< 0.02", ("reference", 99): "< 6.0",
            ("improved", 99): "< 2.0", ("locked", 99): "< 0.1",
            ("anchored", 99): "< 0.25"}
    for who, d in results.items():
        for (name, f), v in d.items():
            print(f"{who}: {name} drift at frame {f}: {v!r}"
                  + (f" (the test's bar {bars[name, f]})"
                     if (name, f) in bars else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
