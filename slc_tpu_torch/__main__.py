"""Command-line interface (PyTorch port of slc_tpu/__main__.py:129-413).

``python -m slc_tpu_torch run``     — replay reconstruction (main.cpp:42-45)
``python -m slc_tpu_torch synth``   — render a synthetic replay dataset
``python -m slc_tpu_torch capture`` — acquire a dataset through the
                                      project->capture loop
``python -m slc_tpu_torch fuse``    — register several scans' depth maps
                                      into one fused cloud

The subcommands and flags are slc_tpu's (all but ``bench``), plus
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def _add_cfg_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cam", default=None,
                   help="camera resolution HxW (default: reference "
                        "1024x1280, StaticParameters.cpp:8-9)")
    p.add_argument("--pro", default=None, help="projector resolution HxW")
    p.add_argument("--gray-bits", type=int, default=None)
    p.add_argument("--phase-steps", type=int, default=None)


def _explicit_cfg_updates(args) -> dict:
    updates = {}
    if args.cam:
        h, w = (int(v) for v in args.cam.split("x"))
        updates.update(cam_h=h, cam_w=w)
    if args.pro:
        h, w = (int(v) for v in args.pro.split("x"))
        updates.update(pro_h=h, pro_w=w)
    if args.gray_bits is not None:
        updates.update(gray_bits=args.gray_bits)
    if args.phase_steps is not None:
        updates.update(phase_steps=args.phase_steps)
    return updates


def _build_cfg(args, manifest=None):
    """REFERENCE_CONFIG <- dataset manifest <- explicit flags, with a
    clear error when a flag contradicts what the dataset records."""
    from slc_tpu_torch.config import REFERENCE_CONFIG
    from_manifest = {}
    if manifest:
        for key in ("cam_h", "cam_w", "pro_h", "pro_w", "gray_bits",
                    "phase_steps"):
            if manifest.get(key) is not None:
                from_manifest[key] = manifest[key]
    explicit = _explicit_cfg_updates(args)
    for k, v in explicit.items():
        if k in from_manifest and from_manifest[k] != v:
            raise SystemExit(
                f"--{k.replace('_', '-')}={v} conflicts with the dataset "
                f"manifest ({k}={from_manifest[k]}); drop the flag or "
                f"regenerate the dataset")
    updates = {**from_manifest, **explicit}
    return (dataclasses.replace(REFERENCE_CONFIG, **updates)
            if updates else REFERENCE_CONFIG)


def _cmd_synth(args, cfg) -> int:
    from slc_tpu_torch import synth
    from slc_tpu_torch.calib import synthetic_calibration
    from slc_tpu_torch.config import HeterodyneConfig
    from slc_tpu_torch.io.dataset import (write_anchor_group,
                                          write_replay_dataset)
    from slc_tpu_torch.io.opencv_yaml import save_calibration
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    surface = (synth.sphere_surface() if args.scene == "sphere"
               else synth.plane_surface(50.0))
    scene = synth.render_static_scene(calib, cfg, surface,
                                      noise_sigma=args.noise)
    fringes = None
    if args.fringes:
        # The multi-frequency stack of --mode heterodyne
        # (slc_tpu/__main__.py:338-344).
        het = HeterodyneConfig(phase_steps=cfg.phase_steps)
        fringes, _, _ = synth.render_fringe_stack(
            calib, cfg, surface, het.periods(cfg.pro_w), het.phase_steps,
            noise_sigma=args.noise)
    frames = None
    dz = 0.08
    stripe_period = 12
    if args.frames:
        # Move the DECODED scene along +z, so frame 0 stays consistent
        # with the absolute decode (slc_tpu/__main__.py:348-357).
        frames, _, _ = synth.render_dynamic_sequence(
            calib, cfg, args.frames, z0=50.0, dz_per_frame=dz,
            stripe_period=stripe_period, noise_sigma=args.noise,
            surface_for_frame=(
                lambda f: synth.offset_surface(surface, dz * f)))
    write_replay_dataset(args.out, scene.gray_images, scene.phase_images,
                         frames, fringes,
                         config_fields={
                             "pro_h": cfg.pro_h, "pro_w": cfg.pro_w,
                             "gray_bits": cfg.gray_bits,
                             "phase_steps": cfg.phase_steps,
                             "scene": args.scene,
                             "noise_sigma": args.noise,
                             "anchor_every": args.anchor_every,
                             "stripe_period": stripe_period,
                         })
    if args.anchor_every:
        for f in range(args.anchor_every, args.frames, args.anchor_every):
            asc = synth.render_static_scene(
                calib, cfg, synth.offset_surface(surface, f * dz),
                noise_sigma=args.noise, seed=f + 1)
            write_anchor_group(args.out, f, asc.gray_images,
                               asc.phase_images)
    os.makedirs(args.out, exist_ok=True)
    save_calibration(os.path.join(args.out, "parameters.yml"), calib)
    print(f"wrote dataset to {args.out} "
          f"({2 * cfg.gray_bits} gray + {cfg.phase_steps} phase + "
          f"{args.frames} dynamic frames, calib parameters.yml)")
    return 0


def _cmd_capture(args, cfg) -> int:
    """Acquisition workflow (slc_tpu/__main__.py:64-126; the reference's
    not-compiled live mode, CCamera.cpp:94-118 / CProjector.cpp:46-76 /
    main.cpp:50-76): drive a Sensor through the synchronous
    project->capture loop over the frame-0 pattern budget (+ per-frame
    stripe captures of the scene moving along +z) and write the result
    as a standard replay dataset. The built-in sensor is the analytic
    SimulatedRig; real hardware is a ``capture.Sensor`` implementation.
    The dataset is byte for byte what ``python -m slc_tpu capture``
    writes."""
    import numpy as np

    from slc_tpu_torch import patterns, synth
    from slc_tpu_torch.calib import synthetic_calibration
    from slc_tpu_torch.capture import (SimulatedRig, capture_sequence,
                                       structured_light_patterns)
    from slc_tpu_torch.io.dataset import write_replay_dataset
    from slc_tpu_torch.io.opencv_yaml import save_calibration

    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    z0, dz = 50.0, 0.08
    surface = (synth.sphere_surface() if args.scene == "sphere"
               else synth.plane_surface(z0))
    rig = SimulatedRig(calib, cfg, surface, noise_sigma=args.noise)
    imgs = capture_sequence(rig, structured_light_patterns(cfg))
    gray = np.stack(imgs[:2 * cfg.gray_bits])
    phase = np.stack(imgs[2 * cfg.gray_bits:])

    frames = None
    if args.frames:
        stripe = patterns.stripe_pattern(cfg.pro_w, cfg.pro_h,
                                         args.stripe_period)
        caps = []
        for f in range(args.frames):
            # The dynamic frames move the DECODED scene, so that frame 0
            # agrees with the tracker's absolute start.
            rig_f = SimulatedRig(calib, cfg,
                                 synth.offset_surface(surface, dz * f),
                                 noise_sigma=args.noise, seed=f + 1)
            caps.extend(capture_sequence(rig_f, [stripe]))
        frames = np.stack(caps)

    write_replay_dataset(args.out, gray, phase, frames,
                         config_fields={
                             "pro_h": cfg.pro_h, "pro_w": cfg.pro_w,
                             "gray_bits": cfg.gray_bits,
                             "phase_steps": cfg.phase_steps,
                             "scene": args.scene,
                             "noise_sigma": args.noise,
                             "captured": True,
                             "stripe_period": args.stripe_period,
                         })
    os.makedirs(args.out, exist_ok=True)
    save_calibration(os.path.join(args.out, "parameters.yml"), calib)
    print(f"captured dataset -> {args.out} ({len(gray)} gray + "
          f"{len(phase)} phase + {args.frames} dynamic frames)")
    return 0


def _cmd_run(args, cfg) -> int:
    from slc_tpu_torch.runner import run_replay
    ref = args.reference_semantics
    if args.phase_lock in ("auto", "off"):
        lock = None if args.phase_lock == "off" else "auto"
    else:
        lock = float(args.phase_lock)
    report = run_replay(
        args.dataset, args.calib, args.out, cfg, device=args.device,
        max_frames=args.max_frames, write_clouds=not args.no_clouds,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        scale_gradient=not ref, subpixel=not ref, robust=not ref,
        mode=args.mode, phase_lock=None if ref else lock,
        refine_period=args.refine_period, save_depth=args.save_depth,
        preview=args.preview, out_format=args.out_format,
        stream=not args.strict_loop,
        frac_bits=7 if args.fast_subpixel and not ref else 0,
        chunk=args.chunk)
    last = report.metrics.records[-1] if report.metrics.records else {}
    print(f"done: frames={report.frames_done} "
          f"first_frame_points={report.first_frame_points} "
          f"last_valid_frac={last.get('valid_frac', 0):.3f}")
    return 0


def _cmd_fuse(args) -> int:
    """Multi-scan registration (BASELINE config 5 as a user flow,
    slc_tpu/__main__.py:129-198): load per-scan depth maps, jointly
    register them with alternating projective association and
    point-to-plane bundle adjustment (fusion_frontend.register_scans) on
    ``--device``, and write the poses plus one fused world-frame cloud."""
    import json

    import numpy as np
    import torch

    from slc_tpu_torch import cloud, se3
    from slc_tpu_torch.fusion import full_f32
    from slc_tpu_torch.fusion_frontend import register_scans

    if len(args.depths) < 2:
        raise SystemExit("fuse needs at least 2 depth_iFrame.npz files")
    zs, cam_k = [], None
    for p in args.depths:
        d = np.load(p)
        if "z" not in d or "cam_k" not in d:
            raise SystemExit(f"{p} is not a depth_iFrame.npz "
                             "(expected arrays 'z' and 'cam_k')")
        if cam_k is None:
            cam_k = d["cam_k"]
        elif not np.allclose(cam_k, d["cam_k"]):
            raise SystemExit(f"{p} has a different cam_k: scans must "
                             "come from the same rig")
        if zs and d["z"].shape != zs[0].shape:
            raise SystemExit(f"{p} depth shape {d['z'].shape} != "
                             f"{zs[0].shape}")
        zs.append(d["z"].astype(np.float32))
    depths = np.stack(zs)
    s = len(zs)
    init_rot = np.tile(np.eye(3, dtype=np.float32), (s, 1, 1))
    init_trans = np.zeros((s, 3), np.float32)
    rot, trans = register_scans(
        depths, cam_k, init_rot, init_trans, rounds=args.rounds,
        gn_iters=args.gn_iters, grid_step=args.grid_step,
        max_depth_err=args.max_depth_err, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "poses.json"), "w") as f:
        json.dump({"scans": args.depths,
                   "world_from_scan": [
                       {"rot": r.tolist(), "trans": t.tolist()}
                       for r, t in zip(rot.cpu().numpy(),
                                       trans.cpu().numpy())]},
                  f, indent=1)

    fx, fy = float(cam_k[0, 0]), float(cam_k[1, 1])
    cx, cy = float(cam_k[0, 2]), float(cam_k[1, 2])
    pts = cloud.depth_to_cloud(torch.from_numpy(depths).to(rot.device), fx,
                               fy, cx, cy).reshape(s, -1, 3)
    with full_f32():
        world = se3.apply(rot, trans[:, None, :], pts).reshape(-1, 3)
    world = world.cpu().numpy()
    n = cloud.write_xyz(os.path.join(args.out, "fused.txt"), world[:, 0],
                        world[:, 1], world[:, 2],
                        mask=depths.reshape(-1) > 0)
    print(f"fused {s} scans -> {args.out}/fused.txt ({n} points), "
          f"poses.json")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="replay reconstruction")
    runp.add_argument("dataset", help="dataset root (iFrame/, cFrame/)")
    runp.add_argument("--calib", required=True,
                      help="OpenCV-YAML calibration (CamMat/ProMat/R/T)")
    runp.add_argument("--out", default="out")
    runp.add_argument("--device", default="cuda",
                      help="torch device: 'cuda' (default; raises "
                           "without CUDA) or 'cpu'")
    runp.add_argument("--max-frames", type=int, default=None)
    runp.add_argument("--no-clouds", action="store_true")
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--resume", action="store_true")
    runp.add_argument("--reference-semantics", action="store_true",
                      help="disable subpixel tracking, gradient scaling, "
                           "the robust deltaP combine and the phase lock "
                           "(exact CCalculation.cpp:595-660 behavior)")
    runp.add_argument("--mode", choices=["gray", "heterodyne", "spatial"],
                      default="gray",
                      help="frame-0 absolute decode method")
    runp.add_argument("--save-depth", action="store_true",
                      help="also write depth_iFrame.npz (frame-0 depth "
                           "+ cam_k) for `fuse`")
    runp.add_argument("--preview", action="store_true",
                      help="write shaded depth preview BMPs (frame 0 "
                           "and the last tracked frame)")
    runp.add_argument("--phase-lock", default="auto",
                      help="'auto' (default: lock to the manifest's "
                           "stripe_period), 'off', or an explicit "
                           "stripe period in projector px")
    runp.add_argument("--refine-period", action="store_true",
                      help="adopt the carrier period measured from the "
                           "first dynamic frame")
    runp.add_argument("--out-format", choices=["xyz", "npz"],
                      default="xyz",
                      help="per-frame cloud format: reference-format "
                           "ASCII or float32 npz maps")
    runp.add_argument("--chunk", type=int, default=1,
                      help="run K consecutive frames as one CUDA graph "
                           "replay (fault/anchor/checkpoint semantics "
                           "preserved; needs the streaming loop)")
    runp.add_argument("--fast-subpixel", action="store_true",
                      help="quantize the tracker's sub-pixel stripe "
                           "fraction to 7 bits (the winner stays exact; "
                           "off under --reference-semantics)")
    runp.add_argument("--strict-loop", action="store_true",
                      help="synchronous read->step->write loop instead "
                           "of read-ahead + background writer")
    _add_cfg_args(runp)

    sy = sub.add_parser("synth", help="render a synthetic replay dataset")
    sy.add_argument("out", help="dataset root to create")
    sy.add_argument("--frames", type=int, default=8)
    sy.add_argument("--noise", type=float, default=1.0)
    sy.add_argument("--scene", choices=["plane", "sphere"], default="sphere")
    sy.add_argument("--fringes", action="store_true",
                    help="also render the multi-frequency fringe stack "
                         "(vFringeCam*) for --mode heterodyne")
    sy.add_argument("--anchor-every", type=int, default=0,
                    help="write absolute re-anchoring pattern groups "
                         "(aFrame{f}/) every K dynamic frames")
    _add_cfg_args(sy)

    cap = sub.add_parser(
        "capture", help="acquire a replay dataset through the "
                        "project->capture loop (simulated rig)")
    cap.add_argument("out", help="dataset root to create")
    cap.add_argument("--scene", choices=["plane", "sphere"],
                     default="sphere")
    cap.add_argument("--frames", type=int, default=0,
                     help="dynamic frames to capture (the scene moving "
                          "along +z, lit by the single stripe pattern)")
    cap.add_argument("--noise", type=float, default=1.0,
                     help="sensor read-noise sigma (gray levels)")
    cap.add_argument("--stripe-period", type=int, default=12)
    _add_cfg_args(cap)

    fu = sub.add_parser(
        "fuse", help="register multiple scans into one fused cloud "
                     "(multi-scan Schur-complement bundle adjustment)")
    fu.add_argument("depths", nargs="+",
                    help="depth_iFrame.npz files from `run --save-depth`"
                         " (>=2, same rig)")
    fu.add_argument("--out", default="fused",
                    help="output dir: poses.json + fused.txt")
    fu.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; raises "
                         "without CUDA) or 'cpu'")
    fu.add_argument("--rounds", type=int, default=4,
                    help="association<->BA alternations")
    fu.add_argument("--gn-iters", type=int, default=5)
    fu.add_argument("--grid-step", type=int, default=8,
                    help="landmark sampling stride (px)")
    fu.add_argument("--max-depth-err", type=float, default=1.0,
                    help="projective-association gate (scene units)")

    args = ap.parse_args(argv)
    if args.cmd == "fuse":
        return _cmd_fuse(args)

    manifest = None
    if args.cmd == "run":
        from slc_tpu_torch.io.dataset import load_manifest
        manifest = load_manifest(args.dataset)
    cfg = _build_cfg(args, manifest)
    if args.cmd == "synth":
        return _cmd_synth(args, cfg)
    if args.cmd == "capture":
        return _cmd_capture(args, cfg)
    return _cmd_run(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())
