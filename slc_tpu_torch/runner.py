"""End-to-end reconstruction runner (PyTorch port of
slc_tpu/runner.py:41-499).

The reference program is ``Init -> CalculateFirst -> CalculateOther``
over a replay dataset, writing one point cloud per frame
(DynaFrame/main.cpp:42-45, CCalculation.cpp:77-357). ``run_replay``
reproduces that flow and adds what slc_tpu adds: per-frame metrics, the
phase lock with its period diagnostic, fault records, anchors,
checkpoints with resume, read-ahead and a background writer. Its
set-up of a sequence is public, for any caller that drives the tracker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from slc_tpu_torch import cloud, visualization
from slc_tpu_torch.calib import (Calibration, TriangulationTables,
                                 build_tables, resolve_device)
from slc_tpu_torch.checkpoint import latest_checkpoint, load_state, save_state
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import (TrackerState, dynamic_step, init_tracker,
                                   reanchor)
from slc_tpu_torch.io.dataset import FaultInjector, ReplayDataset
from slc_tpu_torch.io.opencv_yaml import load_calibration
from slc_tpu_torch.metrics import (MetricsLog, frame_stats,
                                   frame_stats_many, stage)
from slc_tpu_torch.ops.demod import estimate_period, suggest_lock_window
from slc_tpu_torch.pipeline import (FrameResult, decode_first_frame,
                                    decode_heterodyne_frame,
                                    decode_spatial_frame)
from slc_tpu_torch.streaming import (HostStager, chunk_graph, chunk_step_xyz,
                                     one_ahead)

#: Bytes per pixel of one tracker step, lock on or off: frame u8 + three
#: carried f32 maps in, six f32 maps out (slc_tpu adds 21 more for the
#: lock, runner.py:263, an over-count: the lock moves no extra state).
STEP_BYTES_PER_PX = 37


@dataclasses.dataclass
class RunReport:
    frames_done: int
    first_frame_points: int
    metrics: MetricsLog


class LockSetup(NamedTuple):
    """The carrier ``period`` (None: lock off), the demod window ``win_u``
    and the ``period_diag`` summary (None: no diagnostic)."""
    period: Optional[float]
    win_u: int
    diag: Optional[dict]


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: a pageable copy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pattern_group(ds, mode: str, het: HeterodyneConfig,
                  frame: Optional[int] = None) -> List[np.ndarray]:
    """The host images that :func:`decode_absolute` takes in ``mode``, of
    frame 0's pattern group or, with ``frame``, of the aFrame{frame}
    group: the Gray and the phase images ("gray"), the fringe stack
    ("heterodyne") or the phase images ("spatial")."""
    if mode == "gray":
        if frame is None:
            return [ds.gray_images(), ds.phase_images()]
        return [ds.anchor_gray_images(frame), ds.anchor_phase_images(frame)]
    if mode == "heterodyne":
        return [ds.fringe_images(het.num_images) if frame is None
                else ds.anchor_fringe_images(frame, het.num_images)]
    return [ds.phase_images() if frame is None
            else ds.anchor_phase_images(frame)]


def decode_absolute(parts: List[torch.Tensor], mode: str,
                    tables: TriangulationTables, cfg: SystemConfig,
                    het: HeterodyneConfig,
                    anchor: Optional[torch.Tensor] = None) -> FrameResult:
    """The absolute decode of :func:`pattern_group`'s images on the
    device, per mode: frame 0's and every re-anchor's
    (slc_tpu/runner.py:476-498). ``anchor`` (the tracker's current map)
    anchors the spatial unwrap, which is absolute only up to one global
    period offset: unanchored, a re-anchor could snap onto another fringe
    order mid-sequence. Gray and heterodyne decodes ignore it."""
    if mode == "gray":
        return decode_first_frame(parts[0], parts[1], tables, cfg)
    if mode == "heterodyne":
        return decode_heterodyne_frame(parts[0], tables, cfg, het)
    if mode == "spatial":
        return decode_spatial_frame(parts[0], tables, cfg,
                                    float(cfg.phase_period), anchor=anchor)
    raise ValueError(f"unknown mode {mode!r}")


def lock_setup(phase_lock: "str | float | None", manifest: Optional[dict],
               proj_u0: torch.Tensor, frame0=None,
               lock_window: Optional[int] = None,
               refine_period: bool = False) -> LockSetup:
    """The phase lock of a sequence whose frame-0 absolute map is
    ``proj_u0``. ``phase_lock``: "auto" locks to ``manifest``'s
    ``stripe_period`` if it has one, a float forces that period, None
    disables. ``lock_window`` overrides the window suggested from
    ``proj_u0`` (9 with the lock off). With the lock on, the carrier
    period is measured from ``frame0`` (the first dynamic frame on the
    host, or a function that reads it; None: no diagnostic;
    slc_tpu/runner.py:209-258): a deviation > 1% is warned
    about (at ``run_replay``'s caller), and ``refine_period`` adopts the
    estimate if finite and within 10%. An IOError, OSError or ValueError
    of the read or the estimate means no diagnostic."""
    period = None
    if phase_lock == "auto":
        sp = (manifest or {}).get("stripe_period")
        period = float(sp) if sp else None
    elif phase_lock is not None:
        period = float(phase_lock)
    win = (int(lock_window) if lock_window is not None else
           9 if period is None else suggest_lock_window(proj_u0, period))
    if period is None or frame0 is None:
        return LockSetup(period, win, None)
    try:
        frame = upload(frame0() if callable(frame0) else frame0,
                       proj_u0.device)
        t_est = float(estimate_period(frame, proj_u0, period,
                                      win_u=int(win)))
    except (IOError, OSError, ValueError):
        return LockSetup(period, win, None)
    dev_pct = abs(t_est / period - 1.0)
    diag = {"period_diag": True, "period_nominal": period,
            "period_estimated": round(t_est, 5),
            "period_deviation_pct": round(dev_pct * 100, 3),
            "period_adopted": bool(refine_period)}
    if dev_pct > 0.01:
        warnings.warn(
            f"configured stripe period {period} deviates {dev_pct * 100:.1f}%"
            f" from the measured carrier ({t_est:.4f}); the carrier-"
            f"consistency gate will disable the lock at >= ~2% — pass "
            f"refine_period=True (CLI --refine-period) to adopt the "
            f"measured value", stacklevel=3)
    if refine_period:
        if math.isfinite(t_est) and dev_pct < 0.1:
            period = t_est
        else:
            warnings.warn(
                f"refine_period: measured period {t_est!r} is outside the "
                f"estimator's validity envelope (>10% from the configured "
                f"{period}); keeping the configured value", stacklevel=3)
    return LockSetup(period, win, diag)


def start_tracker(ds, first: FrameResult, cfg: SystemConfig,
                  subpixel: bool, device) -> TrackerState:
    """The tracker started on frame 0 of ``ds`` against the absolute map
    ``first``; the frame read with the reference camera's bounded retry
    (30 attempts, CCamera.cpp:97-107)."""
    for _ in range(30):
        try:
            frame0 = ds.frame(0)
            break
        except (IOError, OSError):
            continue
    else:
        raise IOError("frame 0 unreadable after 30 attempts")
    return init_tracker(upload(frame0, device), first.proj_u, first.z, cfg,
                        subpixel)


def run_replay(dataset_root: str, calib: "Calibration | str",
               out_dir: str, cfg: SystemConfig, device="cuda",
               max_frames: Optional[int] = None, write_clouds: bool = True,
               checkpoint_every: int = 0, resume: bool = False,
               scale_gradient: bool = True, subpixel: bool = True,
               robust: bool = True, fault_drop_prob: float = 0.0,
               fault_corrupt_prob: float = 0.0, fault_seed: int = 0,
               mode: str = "gray", use_anchors: bool = True,
               save_depth: bool = False, preview: bool = False,
               phase_lock: "str | float | None" = "auto",
               lock_window: Optional[int] = None,
               refine_period: bool = False, out_format: str = "xyz",
               stream: bool = True, frac_bits: int = 0,
               chunk: int = 1) -> RunReport:
    """Run the reconstruction over a replay dataset on ``device``: frame
    0's absolute decode (:func:`decode_absolute` in ``mode``: "gray",
    "heterodyne" or "spatial"), the phase lock (:func:`lock_setup`, its
    ``period_diag`` summary logged), the tracker (:func:`start_tracker`),
    then the frame loop.

    ``stream`` reads frames ahead on a thread, copies each to the device
    one frame ahead through pinned memory (``streaming.HostStager``, on a
    side stream, out of the timed step) and writes clouds from a
    background thread; ``stream=False`` is the strict read -> step ->
    write loop. Anchor groups (``aFrame{f}/``) re-anchor the tracker when
    ``use_anchors`` is set. ``frac_bits`` > 0 quantizes every tracker
    step's stripe fraction to that many bits (tracker init and re-anchor
    stay exact, as in slc_tpu). ``save_depth`` writes frame 0's depth and
    the camera intrinsics for ``fuse``; ``preview`` writes shaded depth
    renders of frame 0 and of the last tracked frame. ``chunk`` > 1 (with
    ``stream``) runs every K consecutive non-anchor frames as one
    ``streaming.chunk_step_xyz`` (on the card one replay of a graph
    captured once a run, each frame copied into its slot as it is read);
    faults, anchors and the sequence's end flush a partial chunk frame by
    frame, and checkpoints land on chunk boundaries. See
    slc_tpu/runner.py:64-118 for the rationale of each.

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
    # The period diagnostic and the warm-up step read through the base
    # dataset, so that a FaultInjector's draws are not shifted.
    base = getattr(ds, "ds", ds)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w, dev)
    log = MetricsLog()

    # --- frame 0: absolute decode (CalculateFirst) -------------------
    het = HeterodyneConfig(phase_steps=cfg.phase_steps)
    parts = [upload(a, dev) for a in pattern_group(ds, mode, het)]
    # Analytic bytes (u8 planes in, 4 f32 maps out) for achieved GB/s;
    # none for the spatial decode, whose CG iterations vary.
    planes = {"gray": 2 * cfg.gray_bits + cfg.phase_steps,
              "heterodyne": het.num_images}.get(mode)
    first_bytes = planes and cfg.cam_h * cfg.cam_w * (planes + 16)
    # Warm-up out of the timed stage: on the card the first call builds
    # or loads the kernel library.
    decode_absolute(parts, mode, tables, cfg, het)
    with stage("slc/first_frame", log, bytes_moved=first_bytes, device=dev):
        first = decode_absolute(parts, mode, tables, cfg, het)
    ext = "npz" if out_format == "npz" else "txt"
    n_pts, write_frame = 0, None
    if write_clouds:
        write_frame = (cloud.write_cloud_npz if out_format == "npz"
                       else cloud.write_xyz)
        with stage("slc/write", log):
            n_pts = write_frame(os.path.join(out_dir, f"iFrame.{ext}"),
                                first.x, first.y, first.z)
    if save_depth:
        # Depth with its pixel indexing, which ``fuse`` needs.
        np.savez(os.path.join(out_dir, "depth_iFrame.npz"),
                 z=first.z.cpu().numpy().astype(np.float32),
                 cam_k=calib.cam_k.numpy().astype(np.float32))
    if preview:
        _write_preview(out_dir, "preview_iFrame", first.z, calib)
    log.log_frame(0, frame_stats(first.z))

    lock = lock_setup(phase_lock, ds.manifest, first.proj_u,
                      functools.partial(base.frame, 0)
                      if ds.frame_count else None,
                      lock_window, refine_period)
    if lock.diag is not None:
        log.summaries.append(lock.diag)
    track = dict(scale_gradient=scale_gradient, subpixel=subpixel,
                 robust=robust, phase_lock=lock.period,
                 lock_win_u=lock.win_u, frac_bits=frac_bits)

    # --- dynamic loop (CalculateOther) -------------------------------
    latest = latest_checkpoint(os.path.join(out_dir, "ckpt")) if resume \
        else None
    state = None if latest is None else load_state(latest, dev)
    start_frame = 1 if state is None else state.frame_idx + 1
    if state is None:
        if not ds.frame_count:
            log.save(os.path.join(out_dir, "metrics.jsonl"))
            return RunReport(0, n_pts, log)
        state = start_tracker(ds, first, cfg, subpixel, dev)
    total = ds.frame_count if max_frames is None \
        else min(ds.frame_count, max_frames)
    if start_frame < total:
        # Warm-up out of the timed stages; a failed read is the loop's.
        with contextlib.suppress(IOError, OSError, ValueError):
            dynamic_step(state, upload(base.frame(start_frame), dev),
                         tables, cfg, **track)
    # Chunked megastep (slc_tpu/runner.py:347-392): on the card the graph
    # is captured here, out of the timed stages, for every chunk.
    chunked = stream and chunk > 1
    graph = None
    if chunked and dev.type == "cuda" and start_frame + chunk <= total:
        graph = chunk_graph(chunk, *state.z.shape, state.z.device, tables,
                            cfg, **track)
    source = (ds.indexed_frames(start=start_frame, stop=total,
                                prefetch=max(8, chunk))
              if stream else _strict_frames(ds, start_frame, total))
    loop = _Loop(state, start_frame - 1, ds, mode, het, tables, cfg, track,
                 log, dev, set(ds.anchor_frames()) if use_anchors else set(),
                 chunk if chunked else 1, graph, out_dir, ext, write_frame,
                 cloud.AsyncCloudWriter(fmt=out_format)
                 if write_clouds and stream else None, checkpoint_every)
    loop.run(source, ahead=stream and not chunked)
    if preview and loop.done >= start_frame:
        _write_preview(out_dir, f"preview_cFrame{loop.done}", loop.state.z,
                       calib)
    log.save(os.path.join(out_dir, "metrics.jsonl"))
    return RunReport(loop.done, n_pts, log)


def _strict_frames(ds, start: int, stop: int):
    """The strict loop's reads: ``(f, frame, None)`` or ``(f, None, err)``."""
    for f in range(start, stop):
        try:
            yield f, ds.frame(f), None
        except (IOError, OSError, ValueError) as e:
            yield f, None, str(e)


class _Loop:
    """``run_replay``'s frame loop (CalculateOther): each frame stepped
    with ``track`` (dynamic_step's keywords), re-anchored or buffered into
    a chunk (``chunk`` > 1; ``graph`` on the card); clouds to ``writer``
    or ``write_frame`` (None: none); ``done``, the last frame finished."""

    def __init__(self, state: TrackerState, done: int, ds, mode: str,
                 het: HeterodyneConfig, tables: TriangulationTables,
                 cfg: SystemConfig, track: dict, log: MetricsLog, dev,
                 anchors: set, chunk: int, graph, out_dir: str, ext: str,
                 write_frame, writer, checkpoint_every: int):
        self.state, self.done, self.buf = state, done, []
        self.ds, self.mode, self.het = ds, mode, het
        self.tables, self.cfg, self.track = tables, cfg, track
        self.log, self.dev, self.stager = log, dev, HostStager(dev)
        self.anchors, self.chunk, self.graph = anchors, chunk, graph
        self.out_dir, self.ext, self.writer = out_dir, ext, writer
        self.write_frame, self.ckpt_every = write_frame, checkpoint_every
        self.step_bytes = STEP_BYTES_PER_PX * cfg.cam_h * cfg.cam_w

    def run(self, source, ahead: bool) -> None:
        """Every ``(f, frame, error)`` of ``source`` (``ahead``: each frame
        copied to the device one frame ahead), then the writer's close."""
        items = ((f, None if frame is None or self.chunk > 1
                  else self.stager.put(frame), frame, err)
                 for f, frame, err in source)
        try:
            for item in one_ahead(items) if ahead else items:
                self.on_frame(*item)
            self.flush()
        except BaseException:
            if self.writer is not None:
                with contextlib.suppress(IOError):  # the loop's error wins
                    self.writer.close()
            raise
        if self.writer is not None:
            self.log.summaries.append({"writer": True, **self.writer.close()})

    def on_frame(self, f: int, staged, frame, err) -> None:
        if frame is None:
            # Failure recovery: skip the frame, carry the tracker state and
            # record the fault (after the buffered frames).
            self.flush()
            self.log.log_frame(f, frame_stats(self.state.z), fault=err)
            return
        if self.chunk > 1 and f not in self.anchors:
            slot = (None if self.graph is None
                    else self.graph.frames[len(self.buf)])
            self.buf.append((f, self.stager.put(frame, out=slot)))
            if len(self.buf) == self.chunk:
                self.flush()
            return
        if staged is None:      # an anchor of the chunked loop
            staged = self.stager.put(frame)
        if f in self.anchors:
            self.flush()
            # Periodic absolute re-anchoring from an aFrame{f} group.
            with stage("slc/reanchor", self.log, device=self.dev):
                parts = [upload(a, self.dev) for a in
                         pattern_group(self.ds, self.mode, self.het, f)]
                res = decode_absolute(parts, self.mode, self.tables,
                                      self.cfg, self.het,
                                      anchor=self.state.proj_u)
                state = reanchor(self.state, staged.wait(), res.proj_u,
                                 res.z, self.cfg, self.track["subpixel"])
                self.state = dataclasses.replace(state, frame_idx=f)
            self.emit(f, res)
            self.log.log_frame(f, frame_stats(res.z), reanchor=True)
        else:
            with stage("slc/dynamic_step", self.log,
                       bytes_moved=self.step_bytes, device=self.dev):
                self.state, res = self.step(staged.wait())
            self.emit(f, res)
            self.log.log_frame(f, frame_stats(res.z))
        self.commit([f])

    def flush(self) -> None:
        """The buffered frames: a full chunk as one megastep, else each."""
        if not self.buf:
            return
        idxs = [f for f, _ in self.buf]
        if len(idxs) == self.chunk:
            # On the card the frames are in the graph's stack already.
            stack = self.graph.frames if self.graph is not None else \
                torch.stack([sf.wait() for _, sf in self.buf])
            with stage("slc/dynamic_chunk", self.log,
                       bytes_moved=self.step_bytes * len(idxs),
                       device=self.dev):
                self.state, (zs, xs, ys) = chunk_step_xyz(
                    self.state, stack, self.tables, self.cfg,
                    graph=self.graph, **self.track)
            # The writer copies each map before the next chunk's replay
            # (on the card the stacks are the graph's buffers).
            for j, f in enumerate(idxs):
                self.emit(f, FrameResult(x=xs[j], y=ys[j], z=zs[j],
                                         proj_u=None))
            for f, stats in zip(idxs, frame_stats_many(zs)):
                self.log.log_frame(f, stats)
        else:
            for f, sf in self.buf:
                self.state, res = self.step(sf.wait())
                self.emit(f, res)
                self.log.log_frame(f, frame_stats(res.z))
        self.commit(idxs)
        self.buf.clear()

    def step(self, frame: torch.Tensor):
        return dynamic_step(self.state, frame, self.tables, self.cfg,
                            **self.track)

    def emit(self, f: int, res: FrameResult) -> None:
        path = os.path.join(self.out_dir, f"cFrame{f}.{self.ext}")
        if self.writer is not None:
            self.writer.submit(path, res.x, res.y, res.z)
        elif self.write_frame is not None:
            with stage("slc/write", self.log):
                self.write_frame(path, res.x, res.y, res.z)

    def commit(self, idxs: List[int]) -> None:
        """Frames ``idxs`` are done; checkpoint if one is on the interval."""
        if self.ckpt_every and any(f % self.ckpt_every == 0 for f in idxs):
            path = os.path.join(self.out_dir, "ckpt", f"frame_{idxs[-1]}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_state(path, self.state)
        self.done = idxs[-1]


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
