#!/usr/bin/env python3
"""The tile-parallel paths on several ranks of this host, one card each.

    python3 tools/multicard_check.py [--ranks N] [--device cuda|cpu]
        [--shape 1024x1280] [--frames 8]

Starts N ranks (every card by default; NCCL, or gloo ranks with
``--device cpu``) in one process group and, on the near-square mesh of
all of them, at the reference config scaled to ``--shape``:

- ``tiled_absolute_decode`` against the plain decode, bit for bit;
- ``tiled_dynamic_step`` over ``--frames`` frames of a moving plane (open
  loop) against the plain step: P within 1e-4, z within 1e-3 on every
  frame; its host wall per frame (each rank's calls ending in a
  synchronise and a barrier) beside the plain step's on one rank;
- the bytes one ``tiled_batched_dynamic_step`` exchanges per rank
  (``devtime.collective_bytes``);
- ``tiled_unwrap_spatial`` on chip_smoke.py's box-step scene
  (``unwrap_scene``) at the shape and at (h - 24)x(w - 10) against
  ``unwrap_spatial``: cg_iters within 1, P within 1e-3 off the
  zero-quality ring; and each rank's launches of the multigrid kernels,
  which run on its own card (the replicated levels of at least 256 px);

then ``entry.dryrun_multichip(N)``. Every rank computes the references
itself, on its own device, from the same seeded inputs. Prints one line
per check (rank 0's, with every rank's counts) and exits non-zero on any
failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np                                         # noqa: E402
import torch                                               # noqa: E402
import torch.distributed as dist                           # noqa: E402

from chip_smoke import unwrap_scene                       # noqa: E402
from slc_tpu_torch import devtime, synth                   # noqa: E402
from slc_tpu_torch.calib import (build_tables,             # noqa: E402
                                 synthetic_calibration)
from slc_tpu_torch.config import REFERENCE_CONFIG          # noqa: E402
from slc_tpu_torch.dynamic import TrackerState             # noqa: E402
from slc_tpu_torch.kernels import dynamic_step as kstep    # noqa: E402
from slc_tpu_torch.kernels import grayphase as kgray       # noqa: E402
from slc_tpu_torch.kernels import mgsmooth as kmg          # noqa: E402
from slc_tpu_torch.ops import unwrap_spatial as U          # noqa: E402
from slc_tpu_torch.parallel import (gather_image, launch,  # noqa: E402
                                    shard_image, tile_mesh,
                                    tiled_absolute_decode,
                                    tiled_batched_dynamic_step,
                                    tiled_dynamic_step,
                                    tiled_stripe_regression,
                                    tiled_unwrap_spatial)
from slc_tpu_torch.parallel.mesh import mesh_dims          # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_checks(h, w, n_frames):
    """One rank's checks; returns its lines and failures."""
    ctx = launch.initialize()
    dev = ctx.device
    mesh = tile_mesh()
    lines, fails = [], []

    def check(ok, msg):
        lines.append(("ok   " if ok else "FAIL ") + msg)
        if not ok:
            fails.append(msg)

    cfg = dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    lines.append(f"rank {ctx.process_index} of {ctx.process_count} "
                 f"({ctx.backend}) on {dev}, mesh {mesh_dims(mesh)}")

    scene = synth.render_static_scene(calib, cfg, synth.plane_surface(50.0),
                                      noise_sigma=1.0)
    gray = torch.from_numpy(scene.gray_images).to(dev)
    phase = torch.from_numpy(scene.phase_images).to(dev)
    got = tiled_absolute_decode(shard_image(gray, mesh),
                                shard_image(phase, mesh), tables, cfg, mesh)
    want = kgray.grayphase_decode_ref(gray, phase, tables, cfg)
    same = all(torch.equal(gather_image(getattr(got, k), mesh), e)
               for k, e in zip(("x", "y", "z", "proj_u"), want))
    check(same, f"tiled_absolute_decode {h}x{w} equal to the plain decode")

    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, n_frames + 1, z0=50.0, dz_per_frame=0.3,
        stripe_period=12, noise_sigma=1.0)
    frames = torch.from_numpy(frames).to(dev)
    sw, sb = tiled_stripe_regression(shard_image(frames[0], mesh), cfg, mesh)
    tile = TrackerState(proj_u=shard_image(torch.from_numpy(pus[0])
                                           .float().to(dev), mesh),
                        strip_w=sw, strip_b=sb,
                        z=shard_image(torch.from_numpy(zs[0]).float()
                                      .to(dev), mesh), frame_idx=0)
    full = TrackerState(*(gather_image(getattr(tile, k), mesh)
                          for k in ("proj_u", "strip_w", "strip_b", "z")),
                        frame_idx=0)
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    st_t, st_p, err_p, err_z = tile, full, 0.0, 0.0
    for f in range(1, n_frames + 1):
        st_t, res = tiled_dynamic_step(st_t, shard_image(frames[f], mesh),
                                       tables, cfg, mesh)
        out = kstep.dynamic_step_open_ref(frames[f], st_p.strip_w,
                                          st_p.strip_b, st_p.proj_u,
                                          tables, **kw)
        st_p = TrackerState(*out[:4], frame_idx=f)
        err_p = max(err_p, float((gather_image(res.proj_u, mesh)
                                  - out[0]).abs().max()))
        err_z = max(err_z, float((gather_image(res.z, mesh)
                                  - out[3]).abs().max()))
    check(err_p <= 1e-4 and err_z <= 1e-3,
          f"tiled_dynamic_step over {n_frames} frames: max|dP| {err_p:.3e} "
          f"(bar 1e-4), max|dz| {err_z:.3e} (bar 1e-3)")

    def wall(fn, calls=n_frames):
        fn(1)
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(1 + i % n_frames)
        _sync(dev)
        dist.barrier()
        return 1e3 * (time.perf_counter() - t0) / calls

    f_tiles = [shard_image(frames[f], mesh) for f in range(n_frames + 1)]
    walls = [wall(lambda f: tiled_dynamic_step(tile, f_tiles[f], tables,
                                               cfg, mesh)),
             wall(lambda f: kstep.dynamic_step_open_ref(
                 frames[f], full.strip_w, full.strip_b, full.proj_u, tables,
                 **kw))]
    lines.append(f"host wall per frame: tiled step {walls[0]:.4f} ms on "
                 f"{ctx.process_count} ranks, plain step {walls[1]:.4f} ms "
                 f"on each")
    batched = TrackerState(*(getattr(tile, k)[None] for k in
                             ("proj_u", "strip_w", "strip_b", "z")),
                           frame_idx=0)
    nbytes = devtime.collective_bytes(lambda: tiled_batched_dynamic_step(
        batched, f_tiles[1][None], tables, cfg, mesh))
    lines.append(f"collective bytes of one batched step per rank: {nbytes}")

    for uh, uw in ((h, w), (h - 24, w - 10)):
        t, psi, q, anchor, good = unwrap_scene(uh, uw)
        psi, q, anchor = (torch.from_numpy(a).to(dev)
                          for a in (psi, q, anchor))
        before = (kmg.mg_down_cuda.launches, kmg.mg_up_cuda.launches)
        p_t, info_t = tiled_unwrap_spatial(
            shard_image(psi, mesh), t, mesh, quality=shard_image(q, mesh),
            max_iters=800, anchor=shard_image(anchor, mesh),
            return_info=True)
        mg = (kmg.mg_down_cuda.launches - before[0],
              kmg.mg_up_cuda.launches - before[1])
        p_s, info_s = U.unwrap_spatial(psi, t, quality=q, max_iters=800,
                                       anchor=anchor, return_info=True)
        g = torch.from_numpy(good).to(dev)
        err = float(torch.where(g, (gather_image(p_t, mesh) - p_s).abs(),
                                0.0).max())
        check(abs(info_t["cg_iters"] - info_s["cg_iters"]) <= 1
              and err <= 1e-3,
              f"tiled_unwrap_spatial {uh}x{uw}: cg_iters "
              f"{info_t['cg_iters']} / {info_s['cg_iters']}, max|dP| off "
              f"the ring {err:.3e} (bar 1e-3); this rank's mg_down / mg_up "
              f"launches {mg[0]} / {mg[1]}")
    return {"lines": lines, "fails": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shape", default="1024x1280")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    h, w = map(int, args.shape.split("x"))
    n = args.ranks or torch.cuda.device_count()
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with launch.LocalCluster(n, device=args.device, timeout_s=900) as c:
        print(f"{n} ranks joined in {time.perf_counter() - t0:.1f} s",
              flush=True)
        results = c.run(rank_checks, h, w, args.frames)
    for rank, res in enumerate(results):
        for line in (res["lines"] if rank == 0 else
                     [x for x in res["lines"] if "launches" in x
                      or x.startswith("FAIL")]):
            print(f"[rank {rank}] {line}", flush=True)
    fails = [f for r in results for f in r["fails"]]
    from slc_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(n, device=args.device, timeout_s=900)
    print("FAILED: " + "; ".join(fails) if fails else "all checks passed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
