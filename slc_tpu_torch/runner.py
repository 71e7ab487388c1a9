"""End-to-end reconstruction runner (PyTorch port of
slc_tpu/runner.py:41-499).

The reference program is ``Init -> CalculateFirst -> CalculateOther``
over a replay dataset, writing one point cloud per frame
(DynaFrame/main.cpp:42-45, CCalculation.cpp:77-357). ``run_replay``
reproduces that flow and adds what slc_tpu adds: per-frame metrics, the
phase lock with its period diagnostic, fault records, anchors,
checkpoints with resume, read-ahead and a background writer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import warnings
from typing import Optional

import numpy as np
import torch

from slc_tpu_torch import cloud, visualization
from slc_tpu_torch.calib import Calibration, build_tables, resolve_device
from slc_tpu_torch.checkpoint import latest_checkpoint, load_state, save_state
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import dynamic_step, init_tracker, reanchor
from slc_tpu_torch.io.dataset import FaultInjector, ReplayDataset
from slc_tpu_torch.io.opencv_yaml import load_calibration
from slc_tpu_torch.metrics import (MetricsLog, frame_stats,
                                   frame_stats_many, stage)
from slc_tpu_torch.ops.demod import estimate_period, suggest_lock_window
from slc_tpu_torch.pipeline import (FrameResult, decode_first_frame,
                                    decode_heterodyne_frame,
                                    decode_spatial_frame)
from slc_tpu_torch.streaming import HostStager, chunk_graph, chunk_step_xyz

#: Bytes per pixel of one tracker step, lock on or off: frame u8 + three
#: carried f32 maps in, six f32 maps out (slc_tpu adds 21 more for the
#: lock, runner.py:263, an over-count: the lock moves no extra state).
STEP_BYTES_PER_PX = 37


@dataclasses.dataclass
class RunReport:
    frames_done: int
    first_frame_points: int
    metrics: MetricsLog


def run_replay(dataset_root: str, calib: "Calibration | str",
               out_dir: str, cfg: SystemConfig, device="cuda",
               max_frames: Optional[int] = None,
               write_clouds: bool = True,
               checkpoint_every: int = 0,
               resume: bool = False,
               scale_gradient: bool = True,
               subpixel: bool = True,
               robust: bool = True,
               fault_drop_prob: float = 0.0,
               fault_corrupt_prob: float = 0.0,
               fault_seed: int = 0,
               mode: str = "gray",
               use_anchors: bool = True,
               save_depth: bool = False,
               preview: bool = False,
               phase_lock: "str | float | None" = "auto",
               lock_window: Optional[int] = None,
               refine_period: bool = False,
               out_format: str = "xyz",
               stream: bool = True,
               frac_bits: int = 0,
               chunk: int = 1) -> RunReport:
    """Run the reconstruction over a replay dataset on ``device``.

    ``mode`` is the frame-0 absolute decode: "gray" (the reference's
    Gray+phase decode), "heterodyne" (the multi-frequency fringe stack,
    ``vFringeCam*``) or "spatial" (the N phase images, spatially
    unwrapped: absolute up to one global period offset).
    ``phase_lock``: "auto" locks to the manifest's
    ``stripe_period`` when it records one, a float forces that period,
    None disables. With the lock on, the carrier period is measured from
    the first dynamic frame against the frame-0 map and logged as a
    ``period_diag`` summary; a deviation > 1% is warned about and
    ``refine_period`` adopts the estimate when it is finite and within
    10%. ``lock_window`` overrides the demod window (default: suggested
    from the frame-0 map). ``stream`` reads frames ahead on a thread and
    writes clouds from a background thread; ``stream=False`` is the
    strict read -> step -> write loop. Anchor groups (``aFrame{f}/``)
    re-anchor the tracker when ``use_anchors`` is set. ``frac_bits`` > 0
    is the fast sub-pixel mode of every tracker step (the stripe
    fraction quantized to that many bits; tracker init and re-anchor
    stay exact, as in slc_tpu). ``save_depth`` writes frame 0's depth
    and the camera intrinsics for ``fuse``; ``preview`` writes shaded
    depth renders of frame 0 and of the last tracked frame. ``chunk`` >
    1 (with ``stream``) runs every K consecutive non-anchor frames as one
    call of ``streaming.chunk_step_xyz`` (one CUDA graph replay on the
    card): faults, anchors and the end of the sequence flush a partial
    buffer frame by frame first, and checkpoints land on chunk
    boundaries; on the card the run captures the chunk's graph once and
    frees it at its end. Each dynamic frame is copied to the device
    through pinned memory (``streaming.HostStager``): in stream mode one
    frame ahead on a side stream, so the copy is out of the timed step;
    in chunked mode straight into its slot of the graph's frame stack as
    it is read. See slc_tpu/runner.py:64-118 for the rationale of
    each.

    Outputs: <out_dir>/iFrame.<ext>, <out_dir>/cFrame{N}.<ext> ("txt"
    for ``out_format`` "xyz", "npz" for "npz") and metrics.jsonl; with
    ``save_depth`` depth_iFrame.npz (``z`` and ``cam_k``, float32), with
    ``preview`` preview_iFrame.bmp and preview_cFrame{N}.bmp.
    """
    if mode not in ("gray", "heterodyne", "spatial"):
        raise ValueError(f"unknown mode {mode!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(calib, str):
        calib = load_calibration(calib)
    ds = ReplayDataset(dataset_root, gray_count=2 * cfg.gray_bits,
                       phase_count=cfg.phase_steps)
    if fault_drop_prob or fault_corrupt_prob:
        ds = FaultInjector(ds, fault_drop_prob, fault_corrupt_prob,
                           fault_seed)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w, dev)
    log = MetricsLog()

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # Analytic bytes per stage, so metrics.jsonl reports achieved GB/s:
    # a decode reads its u8 planes and writes 4 f32 maps; the spatial
    # decode's CG iteration count is data-dependent, so it has none.
    px = cfg.cam_h * cfg.cam_w
    het = HeterodyneConfig(phase_steps=cfg.phase_steps)
    if mode == "heterodyne":
        first_bytes = px * (het.num_images + 16)
    elif mode == "gray":
        first_bytes = px * (2 * cfg.gray_bits + cfg.phase_steps + 16)
    else:
        first_bytes = None
    step_bytes = STEP_BYTES_PER_PX * px

    # --- frame 0: absolute decode (CalculateFirst) -------------------
    if mode == "gray":
        do_decode = functools.partial(
            decode_first_frame, to_dev(ds.gray_images()),
            to_dev(ds.phase_images()), tables, cfg)
    elif mode == "heterodyne":
        do_decode = functools.partial(
            decode_heterodyne_frame,
            to_dev(ds.fringe_images(het.num_images)), tables, cfg, het)
    else:
        do_decode = functools.partial(
            decode_spatial_frame, to_dev(ds.phase_images()), tables, cfg,
            float(cfg.phase_period))
    # Warm-up out of the timed stage: on the card the first call builds
    # or loads the kernel library.
    do_decode()
    with stage("slc/first_frame", log, bytes_moved=first_bytes, device=dev):
        first = do_decode()
    ext = "npz" if out_format == "npz" else "txt"
    write_frame = (cloud.write_cloud_npz if out_format == "npz"
                   else cloud.write_xyz)
    n_pts = 0
    if write_clouds:
        with stage("slc/write", log):
            n_pts = write_frame(os.path.join(out_dir, f"iFrame.{ext}"),
                                first.x, first.y, first.z)
    if save_depth:
        # Machine-readable depth for multi-scan fusion (``python -m
        # slc_tpu_torch fuse``): the ASCII clouds drop pixel indexing,
        # which projective association needs.
        np.savez(os.path.join(out_dir, "depth_iFrame.npz"),
                 z=first.z.cpu().numpy().astype(np.float32),
                 cam_k=calib.cam_k.numpy().astype(np.float32))
    if preview:
        _write_preview(out_dir, "preview_iFrame", first.z, calib)
    log.log_frame(0, frame_stats(first.z))

    # Phase-locked tracking: the stripe period from the manifest, the
    # demod window from the frame-0 absolute map.
    lock_period = None
    if phase_lock == "auto":
        sp = (ds.manifest or {}).get("stripe_period")
        lock_period = float(sp) if sp else None
    elif phase_lock is not None:
        lock_period = float(phase_lock)
    lock_win = 9
    if lock_period is not None and lock_window is None:
        lock_win = suggest_lock_window(first.proj_u, lock_period)
    elif lock_window is not None:
        lock_win = int(lock_window)

    if lock_period is not None and ds.frame_count:
        # Period diagnostic (+ opt-in refinement) from the first dynamic
        # frame, read through the BASE dataset so a FaultInjector's RNG
        # sequence is not shifted (slc_tpu/runner.py:209-258).
        try:
            base_ds = getattr(ds, "ds", ds)
            t_est = float(estimate_period(
                to_dev(base_ds.frame(0)), first.proj_u, float(lock_period),
                win_u=int(lock_win)))
        except (IOError, OSError, ValueError):
            t_est = None
        if t_est is not None:
            dev_pct = abs(t_est / lock_period - 1.0)
            log.summaries.append(
                {"period_diag": True,
                 "period_nominal": float(lock_period),
                 "period_estimated": round(t_est, 5),
                 "period_deviation_pct": round(dev_pct * 100, 3),
                 "period_adopted": bool(refine_period)})
            if dev_pct > 0.01:
                warnings.warn(
                    f"configured stripe period {lock_period} deviates "
                    f"{dev_pct * 100:.1f}% from the measured carrier "
                    f"({t_est:.4f}); the carrier-consistency gate "
                    f"will disable the lock at >= ~2% — pass "
                    f"refine_period=True (CLI --refine-period) to "
                    f"adopt the measured value", stacklevel=2)
            if refine_period:
                if math.isfinite(t_est) and dev_pct < 0.1:
                    lock_period = t_est
                else:
                    warnings.warn(
                        f"refine_period: measured period {t_est!r} is "
                        f"outside the estimator's validity envelope "
                        f"(>10% from the configured {lock_period}); "
                        f"keeping the configured value", stacklevel=2)

    def step(st, frame_dev):
        return dynamic_step(st, frame_dev, tables, cfg, scale_gradient,
                            subpixel, robust, phase_lock=lock_period,
                            lock_win_u=lock_win, frac_bits=frac_bits)

    # --- dynamic loop (CalculateOther) -------------------------------
    ckpt_dir = os.path.join(out_dir, "ckpt")
    start_frame = 1
    state = None
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            state = load_state(latest, dev)
            start_frame = state.frame_idx + 1
    if state is None:
        if not ds.frame_count:
            log.save(os.path.join(out_dir, "metrics.jsonl"))
            return RunReport(0, n_pts, log)
        # Bounded retry for the tracking anchor frame (the reference
        # camera's 30-attempt snapshot loop, CCamera.cpp:97-107).
        frame0 = None
        for _ in range(30):
            try:
                frame0 = ds.frame(0)
                break
            except (IOError, OSError):
                continue
        if frame0 is None:
            raise IOError("frame 0 unreadable after 30 attempts")
        state = init_tracker(to_dev(frame0), first.proj_u, first.z, cfg,
                             subpixel)

    total = ds.frame_count if max_frames is None \
        else min(ds.frame_count, max_frames)
    anchor_set = set(ds.anchor_frames()) if use_anchors else set()
    if start_frame < total:
        # Warm-up step out of the timed stages (best effort: a read
        # failure is handled by the loop's own fault path). Read through
        # the base dataset so injected faults are not shifted.
        try:
            base_ds = getattr(ds, "ds", ds)
            step(state, to_dev(base_ds.frame(start_frame)))
        except (IOError, OSError, ValueError):
            pass
    # Chunked megastep (slc_tpu/runner.py:347-392): consecutive
    # non-anchor frames run K at a time. On the card the chunk's graph
    # is captured here, out of the timed stages (capturing launches
    # nothing), and serves every chunk of this run.
    chunked = stream and chunk > 1
    graph = None
    if chunked and dev.type == "cuda" and start_frame + chunk <= total:
        h, w = state.z.shape
        graph = chunk_graph(chunk, h, w, state.z.device, tables, cfg,
                            scale_gradient, subpixel, robust, lock_period,
                            lock_win, frac_bits=frac_bits)

    if stream:
        # Read-ahead of at least one chunk.
        frame_source = ds.indexed_frames(start=start_frame, stop=total,
                                         prefetch=max(8, chunk))
    else:
        def _strict_source():
            for i in range(start_frame, total):
                try:
                    yield i, ds.frame(i), None
                except (IOError, OSError, ValueError) as e:
                    yield i, None, str(e)
        frame_source = _strict_source()
    stager = HostStager(dev)

    def staged_source():
        """frame_source with each frame's copy to the device started, in
        stream mode one frame ahead of the frame handed on. In chunked
        mode frames are handed on as read: the loop copies each into its
        slot of the chunk (the slot is read by the previous chunk's
        replay until that is queued)."""
        pending = None
        for f, frame, err in frame_source:
            item = (f, None if frame is None or chunked
                    else stager.put(frame), frame, err)
            if not stream or chunked:
                yield item
                continue
            if pending is not None:
                yield pending
            pending = item
        if pending is not None:
            yield pending

    writer = None
    if write_clouds and stream:
        writer = cloud.AsyncCloudWriter(fmt=out_format)

    def emit(f, res):
        path = os.path.join(out_dir, f"cFrame{f}.{ext}")
        if writer is not None:
            writer.submit(path, res.x, res.y, res.z)
        elif write_clouds:
            with stage("slc/write", log):
                write_frame(path, res.x, res.y, res.z)

    chunk_buf: list = []

    def flush():
        """Run the buffered frames: a full chunk as one megastep, a
        partial one frame by frame; then its checkpoint."""
        nonlocal state, done
        if not chunk_buf:
            return
        idxs = [cf for cf, _ in chunk_buf]
        if len(idxs) == chunk:
            # On the card the frames are in the graph's stack already.
            stack = graph.frames if graph is not None else torch.stack(
                [sf.wait() for _, sf in chunk_buf])
            with stage("slc/dynamic_chunk", log,
                       bytes_moved=step_bytes * len(idxs), device=dev):
                state, (zs, xs, ys) = chunk_step_xyz(
                    state, stack, tables, cfg, scale_gradient, subpixel,
                    robust, phase_lock=lock_period, lock_win_u=lock_win,
                    frac_bits=frac_bits, graph=graph)
            # The writer copies each map before the next chunk's replay
            # (on the card the stacks are the graph's buffers).
            for j, cf in enumerate(idxs):
                emit(cf, FrameResult(x=xs[j], y=ys[j], z=zs[j],
                                     proj_u=None))
            for cf, stats in zip(idxs, frame_stats_many(zs)):
                log.log_frame(cf, stats)
        else:
            for cf, sf in chunk_buf:
                state, res = step(state, sf.wait())
                emit(cf, res)
                log.log_frame(cf, frame_stats(res.z))
        if checkpoint_every and any(
                cf % checkpoint_every == 0 for cf in idxs):
            os.makedirs(ckpt_dir, exist_ok=True)
            save_state(os.path.join(ckpt_dir, f"frame_{idxs[-1]}"), state)
        done = idxs[-1]
        chunk_buf.clear()

    done = start_frame - 1
    loop_exc = None
    try:
        for f, staged, frame, err in staged_source():
            if frame is None:
                # Failure recovery: skip the frame, carry the tracker
                # state, record the fault (buffered frames first, so the
                # logged state is current).
                flush()
                log.log_frame(f, frame_stats(state.z), fault=err)
                continue
            if chunked and f not in anchor_set:
                slot = None if graph is None else graph.frames[len(chunk_buf)]
                chunk_buf.append((f, stager.put(frame, out=slot)))
                if len(chunk_buf) == chunk:
                    flush()
                continue
            if staged is None:      # an anchor of the chunked loop
                staged = stager.put(frame)
            if f in anchor_set:
                flush()
                # Periodic absolute re-anchoring from an aFrame{f} group.
                with stage("slc/reanchor", log, device=dev):
                    res = _decode_anchor(ds, f, tables, cfg, mode, het,
                                         to_dev, state.proj_u)
                    state = reanchor(state, staged.wait(), res.proj_u,
                                     res.z, cfg, subpixel)
                    state = dataclasses.replace(state, frame_idx=f)
                emit(f, res)
                log.log_frame(f, frame_stats(res.z), reanchor=True)
            else:
                with stage("slc/dynamic_step", log, bytes_moved=step_bytes,
                           device=dev):
                    state, res = step(state, staged.wait())
                emit(f, res)
                log.log_frame(f, frame_stats(res.z))
            if checkpoint_every and f % checkpoint_every == 0:
                os.makedirs(ckpt_dir, exist_ok=True)
                save_state(os.path.join(ckpt_dir, f"frame_{f}"), state)
            done = f
        flush()
    except BaseException as e:
        loop_exc = e
        raise
    finally:
        if writer is not None:
            try:
                log.summaries.append({"writer": True, **writer.close()})
            except IOError:
                # Do not mask an in-flight loop exception with the
                # writer's failure report.
                if loop_exc is None:
                    raise

    if preview and done >= start_frame:
        _write_preview(out_dir, f"preview_cFrame{done}", state.z, calib)
    log.save(os.path.join(out_dir, "metrics.jsonl"))
    return RunReport(done, n_pts, log)


def _write_preview(out_dir: str, name: str, z: torch.Tensor,
                   calib: Calibration) -> str:
    """Shaded depth preview BMP (the depthMapUtils.cpp:167-187 render
    chain: bilateral -> normals -> Phong-style luminance), rendered on
    the device of ``z``."""
    k = calib.cam_k.numpy()
    lum = cloud.render_depth_map(z, float(k[0, 0]), float(k[1, 1]),
                                 float(k[0, 2]), float(k[1, 2]))
    return visualization.show(name, lum.cpu().numpy(), out_dir=out_dir,
                              force=True)


def _decode_anchor(ds, f: int, tables, cfg: SystemConfig, mode: str,
                   het: HeterodyneConfig, to_dev, prev_proj_u):
    """Absolute decode of the aFrame{f} pattern group, per mode
    (slc_tpu/runner.py:476-498).

    ``prev_proj_u`` (the tracker's current absolute map) anchors the
    spatial mode's unwrap: a spatial decode is absolute only up to one
    global period offset, so an unanchored re-anchor could snap the
    sequence onto another fringe order and put a period-sized depth jump
    mid-sequence. Gray and heterodyne decodes are absolute on their own
    and ignore it."""
    if mode == "gray":
        return decode_first_frame(to_dev(ds.anchor_gray_images(f)),
                                  to_dev(ds.anchor_phase_images(f)),
                                  tables, cfg)
    if mode == "heterodyne":
        return decode_heterodyne_frame(
            to_dev(ds.anchor_fringe_images(f, het.num_images)), tables, cfg,
            het)
    return decode_spatial_frame(to_dev(ds.anchor_phase_images(f)), tables,
                                cfg, float(cfg.phase_period),
                                anchor=prev_proj_u)
