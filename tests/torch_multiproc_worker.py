"""Worker process for tests/test_torch_multiprocess.py (the port's
tests/multiproc_worker.py).

Each process joins a gloo process group through the SLC_* environment
contract of slc_tpu_torch.parallel.launch, builds the global scan x tile
mesh (SLC_SCAN scan groups), feeds its scan rows through
``shard_host_batch`` into one ``tiled_batched_dynamic_step``, whose
metrics all-reduce crosses the process boundary, and checks its tiles
against the port's single-device step, computed in-process. Then the
tiled heterodyne decode and the multigrid spatial unwrap, whose V-cycle
all-gathers its coarse levels across processes. Writes a JSON verdict to
$SLC_OUT; the coordinator also writes the gathered maps to $SLC_OUT.npz
for the test to hold against slc_tpu. Imports neither jax nor slc_tpu.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

from slc_tpu_torch import synth
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import TrackerState, dynamic_step, init_tracker
from slc_tpu_torch.ops.unwrap_spatial import unwrap_spatial
from slc_tpu_torch.parallel import (SCAN, TILE_X, TILE_Y, gather_image,
                                    launch, shard_image,
                                    tiled_batched_dynamic_step,
                                    tiled_heterodyne_decode,
                                    tiled_unwrap_spatial)
from slc_tpu_torch.parallel.halo import all_reduce
from slc_tpu_torch.parallel.mesh import mesh_dims, world_group
from slc_tpu_torch.pipeline import decode_heterodyne_frame

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                   gray_bits=5, phase_steps=4)
STATE = ("proj_u", "strip_w", "strip_b", "z")


def main() -> dict:
    torch.set_num_threads(1)
    ctx = launch.initialize(device="cpu", timeout_s=120)
    mesh = launch.global_tile_mesh(scan=int(os.environ["SLC_SCAN"]))
    n_scans = mesh_dims(mesh)[SCAN]

    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w, device="cpu")

    # Per-scan data rendered identically by every process: scan s is a
    # plane at z0 = 48 + 2 s moving between frames.
    states, frame0s, frame1s = [], [], []
    for s in range(n_scans):
        frames, zs, pus = synth.render_dynamic_sequence(
            calib, CFG, 2, z0=48.0 + 2.0 * s, dz_per_frame=0.5,
            stripe_period=12)
        frame0s.append(frames[0])
        frame1s.append(frames[1])
        states.append(init_tracker(torch.from_numpy(frames[0]),
                                   torch.from_numpy(pus[0]).float(),
                                   torch.from_numpy(zs[0]).float(), CFG))

    # Golden: the single-device plain step per scan.
    golden = [dynamic_step(states[s], torch.from_numpy(frame1s[s]), tables,
                           CFG)[1] for s in range(n_scans)]
    golden_valid = float(np.mean([float((g.z > 0).float().mean())
                                  for g in golden]))

    # Distributed inputs: each process feeds only its scan rows.
    rows = launch.local_scan_slice(mesh, n_scans)
    spec = (SCAN, TILE_Y, TILE_X)

    def feed(stack):
        return launch.shard_host_batch(mesh, stack[rows], spec,
                                       device="cpu")

    st = TrackerState(**{k: feed(np.stack([getattr(states[s], k).numpy()
                                           for s in range(n_scans)]))
                         for k in STATE}, frame_idx=0)
    frames_l = feed(np.stack(frame1s))
    # A global reduction of the sharded frames is the sum of every scan.
    total = float(all_reduce(frames_l.double().sum(), world_group(mesh)))
    expect_total = float(np.stack(frame1s).astype(np.float64).sum())

    new, res, metrics = tiled_batched_dynamic_step(st, frames_l, tables,
                                                   CFG, mesh)
    z = gather_image(res.z, mesh, scan=True).numpy()
    pu = gather_image(res.proj_u, mesh, scan=True).numpy()
    z_err = max(float(np.abs(z[s] - golden[s].z.numpy()).max())
                for s in range(n_scans))
    pu_err = max(float(np.abs(pu[s] - golden[s].proj_u.numpy()).max())
                 for s in range(n_scans))
    valid_frac = float(metrics["valid_frac"])

    # Cross-process coverage of the other flagship tiled paths.
    het = HeterodyneConfig()
    imgs, _, _ = synth.render_fringe_stack(
        calib, CFG, synth.plane_surface(55.0, 0.1, 0.05),
        het.periods(CFG.pro_w), het.phase_steps, noise_sigma=1.0)
    ref_het = decode_heterodyne_frame(torch.from_numpy(imgs), tables, CFG,
                                      het)
    got_het = tiled_heterodyne_decode(shard_image(torch.from_numpy(imgs),
                                                  mesh), tables, CFG, het,
                                      mesh)
    het_err = float((gather_image(got_het.z, mesh) - ref_het.z).abs().max())

    t = 24.0
    xs = (np.linspace(0, 5 * t, CFG.cam_w)[None, :]
          + 0.4 * np.arange(CFG.cam_h)[:, None]).astype(np.float32)
    psi = torch.from_numpy(np.mod(xs, t).astype(np.float32))
    anchor = torch.from_numpy(xs)
    ref_unwrap = unwrap_spatial(psi, t, max_iters=200, anchor=anchor)
    got_unwrap = tiled_unwrap_spatial(shard_image(psi, mesh), t, mesh,
                                      max_iters=200,
                                      anchor=shard_image(anchor, mesh))
    unwrap_err = float((gather_image(got_unwrap, mesh)
                        - ref_unwrap).abs().max())

    if ctx.is_coordinator:
        np.savez(os.environ["SLC_OUT"] + ".npz", z=z, proj_u=pu,
                 valid_frac=valid_frac)
    return {
        "process_index": ctx.process_index,
        "process_count": ctx.process_count,
        "backend": ctx.backend,
        "mesh": mesh_dims(mesh),
        "local_scan_slice": [rows.start, rows.stop],
        "tile_shape": list(frames_l.shape),
        "max_z_err": z_err,
        "max_pu_err": pu_err,
        "valid_frac": valid_frac,
        "golden_valid_frac": golden_valid,
        "sum_err": abs(total - expect_total),
        "frame_idx": new.frame_idx,
        "het_err": het_err,
        "unwrap_err": unwrap_err,
        "foreign_modules": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "slc_tpu")),
        "ok": (z_err < 1e-3 and pu_err < 1e-4
               and abs(valid_frac - golden_valid) < 1e-5
               and abs(total - expect_total) < 1e-2
               and het_err < 1e-4 and unwrap_err < 1e-3),
    }


if __name__ == "__main__":
    out = os.environ["SLC_OUT"]
    try:
        res = main()
    except Exception:
        res = {"ok": False, "error": traceback.format_exc()}
    finally:
        launch.shutdown()
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    sys.exit(0 if res.get("ok") else 1)
