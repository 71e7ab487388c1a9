"""Driver entry points of the port (counterparts of __graft_entry__.py).

``entry()``             the single-card forward step of the flagship
                        pipeline: the Gray+phase frame-0 decode and
                        triangulation at the reference resolution, on the
                        card unless the caller asks for the CPU.
``dryrun_multichip(n)`` one full multi-device step on an n-rank mesh at
                        tiny shapes: n ranks on this host (one card each
                        with NCCL, or gloo ranks on the CPU with
                        ``device="cpu"``), each path of
                        :mod:`slc_tpu_torch.parallel` once.
"""

from __future__ import annotations

import numpy as np
import torch

from slc_tpu_torch.parallel.launch import DEFAULT_TIMEOUT_S, LocalCluster


def entry(device="cuda"):
    """(fn, example_args): the Gray+phase absolute decode -> unwrap merge
    -> rational triangulation at the reference camera resolution
    (1280x1024, StaticParameters.cpp:8-9), on ``device``."""
    from slc_tpu_torch.calib import build_tables, synthetic_calibration
    from slc_tpu_torch.config import REFERENCE_CONFIG as cfg
    from slc_tpu_torch.pipeline import decode_first_frame

    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w, device)

    def fn(gray_images, phase_images):
        res = decode_first_frame(gray_images, phase_images, tables, cfg)
        return res.x, res.y, res.z, res.proj_u

    rng = np.random.default_rng(0)
    dev = tables.c.device
    gray = torch.from_numpy(rng.integers(
        0, 256, size=(2 * cfg.gray_bits, cfg.cam_h, cfg.cam_w),
        dtype=np.uint8)).to(dev)
    phase = torch.from_numpy(rng.integers(
        0, 256, size=(cfg.phase_steps, cfg.cam_h, cfg.cam_w),
        dtype=np.uint8)).to(dev)
    return fn, (gray, phase)


def _dryrun_rank(n: int) -> dict:
    """One rank of :func:`dryrun_multichip`: the five paths on a (scan,
    ty, tx) mesh over every rank, at tiny shapes."""
    from slc_tpu_torch import fusion
    from slc_tpu_torch.calib import build_tables, synthetic_calibration
    from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
    from slc_tpu_torch.dynamic import TrackerState
    from slc_tpu_torch.fusion_frontend import anchor_gauge_align
    from slc_tpu_torch.parallel import (SCAN, TILE_X, TILE_Y, launch,
                                        shard_image, tile_mesh,
                                        tiled_absolute_decode,
                                        tiled_batched_dynamic_step,
                                        tiled_heterodyne_decode,
                                        tiled_unwrap_spatial)
    from slc_tpu_torch.parallel.fusion_tiled import (fusion_mesh,
                                                     shard_landmarks,
                                                     tiled_fuse_scans)
    from slc_tpu_torch.parallel.halo import all_gather_cat
    from slc_tpu_torch.parallel.mesh import (mesh_dims, tile_counts,
                                             world_group)

    ctx = launch.initialize()
    dev = ctx.device
    scan = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = tile_mesh(scan=scan)
    ty, tx = tile_counts(mesh)

    # Tiny but tile-compatible shapes: tiles must cover the 11-px halo.
    cfg = SystemConfig(cam_h=max(2 * ty, 1) * 32, cam_w=max(2 * tx, 1) * 64,
                       pro_h=64, pro_w=1280, gray_bits=6, phase_steps=4)
    h, w = cfg.cam_h, cfg.cam_w
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    rng = np.random.default_rng(0)

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape,
                                             dtype=np.uint8)).to(dev)

    gray = shard_image(u8((2 * cfg.gray_bits, h, w)), mesh)
    phase = shard_image(u8((cfg.phase_steps, h, w)), mesh)

    # 1: tile-parallel absolute decode (frame 0).
    first = tiled_absolute_decode(gray, phase, tables, cfg, mesh)

    # 2: tile-parallel heterodyne decode.
    het = HeterodyneConfig()
    fringes = shard_image(u8((het.num_images, h, w)), mesh)
    het_res = tiled_heterodyne_decode(fringes, tables, cfg, het, mesh)

    # 3: tiled spatial unwrap, distributed CG with a halo exchange per
    # matvec and all-reduced dot products.
    psi = shard_image(torch.from_numpy(
        rng.uniform(0, 32.0, (h, w)).astype(np.float32)).to(dev), mesh)
    unwrapped = tiled_unwrap_spatial(psi, 32.0, mesh, max_iters=8)

    # 4: one batched dynamic step (scan groups x tiles).
    zeros = torch.zeros_like(first.z)[None]
    states = TrackerState(proj_u=first.proj_u[None], strip_w=zeros,
                          strip_b=zeros, z=first.z[None], frame_idx=0)
    frames = rng.integers(0, 256, (scan, h, w), dtype=np.uint8)
    frames = launch.shard_host_batch(
        mesh, frames[launch.local_scan_slice(mesh, scan)],
        (SCAN, TILE_Y, TILE_X), device=dev)
    new_states, _, metrics = tiled_batched_dynamic_step(
        states, frames, tables, cfg, mesh)
    v = float(metrics["valid_frac"])
    for name, t in (("metrics", metrics["mean_z"]),
                    ("heterodyne decode", het_res.z),
                    ("tiled spatial unwrap", unwrapped),
                    ("batched step", new_states.proj_u)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} in the multi-device "
                               f"step")

    # 5: landmark-sharded bundle adjustment on a 1-D mesh over the same
    # ranks (all-reduced Schur terms, replicated 6S x 6S solve), held
    # against the single-device solver at the same damping, then the
    # anchor gauge re-registration the multi-scan frontend finishes
    # with. (__graft_entry__.py:139-146 compares across the two
    # functions' default dampings, 1e-6 and 1e-3: that alone moves the
    # poses by 1.3e-4 to 2.5e-4 on fewer than 8 devices.)
    s_scans, n_lm = 4, 8 * n
    obs, mask, _, _ = fusion.synthetic_problem(
        np.random.default_rng(1), s=s_scans, l=n_lm, noise=0.01, device=dev)
    fmesh = fusion_mesh()
    obs_l, mask_l = shard_landmarks(fmesh, obs, mask)
    rot_d, trans_d, lm_l = tiled_fuse_scans(obs_l, mask_l, fmesh, iters=6)
    rot_1, trans_1, _ = fusion.fuse_scans(obs, mask, iters=6,
                                          damping=1e-6)
    delta = max(float((rot_d - rot_1).abs().max()),
                float((trans_d - trans_1).abs().max()))
    if not delta < 1e-4:
        raise RuntimeError(f"distributed fusion diverges from "
                           f"single-device: {delta}")
    lm_d = all_gather_cat(lm_l, 0, world_group(fmesh))
    normals = torch.tensor([0.0, 0.0, 1.0], dtype=obs.dtype,
                           device=dev).expand(n_lm, 3)
    _, trans_g = anchor_gauge_align(rot_d, trans_d, obs, mask, lm_d,
                                    normals, n_anchor_landmarks=n_lm // 2)
    if not bool(torch.isfinite(trans_g).all()):
        raise RuntimeError("non-finite gauge-aligned poses")

    dims = mesh_dims(mesh)
    line = (f"dryrun_multichip ok: mesh={dims} cam={h}x{w} "
            f"valid_frac={v:.3f} fusion_parity_delta={delta:.2e} "
            f"backend={ctx.backend} "
            f"paths=absolute+heterodyne+spatial_unwrap+dynamic_step+fusion")
    if ctx.is_coordinator:
        print(line, flush=True)
    return {"line": line, "mesh": dims, "valid_frac": v,
            "fusion_parity_delta": delta, "backend": ctx.backend}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Start ``n_devices`` ranks on this host (one card each with NCCL,
    or gloo ranks on the CPU with ``device="cpu"``) and run one full
    multi-device step on them at tiny shapes: (1) the tiled Gray+phase
    absolute decode, (2) the tiled heterodyne decode, (3) a tiled spatial
    unwrap, (4) the batched dynamic step on a ``scan=2`` mesh when n is
    at least 4 and even, (5) tiled fusion, held within 1e-4 of
    ``fusion.fuse_scans``. Rank 0 prints ``dryrun_multichip ok: ...``;
    returns its summary. A fault on any rank raises."""
    with LocalCluster(n_devices, device=device,
                      timeout_s=timeout_s) as cluster:
        return cluster.run(_dryrun_rank, n_devices)[0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
