"""Streaming dynamic reconstruction with transfer/compute overlap
(PyTorch port of slc_tpu/streaming.py).

The reference's dynamic loop is strictly synchronous: imread -> track ->
write, one frame at a time (CCalculation.cpp:221-316). slc_tpu pipelines
it with JAX's asynchronous dispatch; on a CUDA card the port does the
same with streams, events and graphs:

  * frame f+1 is copied into a pinned host buffer and sent to the device
    on a side stream while step f runs on the current stream
    (:class:`HostStager`: both copies are queued on the side stream, the
    one into pinned memory as a host function that CUDA's callback
    thread runs, so the caller's thread only enqueues); the step waits on
    its frame's copy event, the host does not;
  * the default ``fetch`` copies each depth map into pinned host memory
    asynchronously, on the current stream behind its step
    (slc_tpu's ``copy_to_host_async``);
  * K steps run as one CUDA graph (:class:`ChunkGraph`), captured once
    for a (K, H, W, tracker flags, lock window, ``frac_bits``) and
    replayed per chunk: the same kernel launches as K single steps (four
    per locked step, one per open-loop step), with no host work between
    them. It adds no kernel and replaces none. The caller that captures
    a graph owns it (the runner, for one run), and the graph is freed
    with it.

The loops never wait for the device per frame, so the copy of frame f+1
runs while the caller's thread launches step f.

On the CPU the same functions are plain loops over
:func:`slc_tpu_torch.dynamic.dynamic_step`. A CUDA tensor never takes
the CPU loop, and a failed capture, replay or pinned allocation raises.

State and buffers (the port's rule in place of slc_tpu's donation): a
yielded or returned :class:`TrackerState` never aliases a buffer that a
later call overwrites (a chunk's carried maps are copied out of the
graph's buffers), so a caller may keep it or checkpoint it. The (K, H,
W) stacks that :func:`chunk_step_xyz` and :func:`stream_chunks` give on
the card ARE the graph's output buffers: they hold until the next call
of the same graph. Consume or copy them before that, as the runner does
(its writer copies them into pinned host memory on the current stream,
which orders the copy before the next replay).

Launch counts: a wrapper counts where it launches. Capturing launches
nothing, so the counts a capture adds are taken back; each replay adds K
launches to the step's wrapper.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.calib import TriangulationTables
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import TrackerState, dynamic_step, step_maps
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import staging as kstaging
from slc_tpu_torch.pipeline import FrameResult


@dataclasses.dataclass
class StreamStats:
    """Per-frame latency / throughput of a streaming run.

    In chunked mode, ``chunk_latencies_s``/``chunk_sizes`` record the
    per-chunk sync-to-sync wall times directly (a ragged final chunk
    makes them unrecoverable from the flattened per-frame list)."""
    latencies_s: List[float]
    chunk_latencies_s: Optional[List[float]] = None
    chunk_sizes: Optional[List[int]] = None

    @property
    def fps(self) -> float:
        return len(self.latencies_s) / max(sum(self.latencies_s), 1e-12)

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.latencies_s), q) * 1e3)

    def summary(self) -> dict:
        return {"frames": len(self.latencies_s),
                "fps": round(self.fps, 2),
                "p50_ms": round(self.percentile_ms(50), 3),
                "p95_ms": round(self.percentile_ms(95), 3)}


class Staged:
    """A host frame (or stack of frames) on its way to the device: the
    device tensor, the event of its copy where that copy runs on another
    stream than the one that reads it, and the stager's ordinal of the
    ``put`` that made it (the ``frame`` of its ``stream.put`` span)."""

    def __init__(self, tensor: torch.Tensor,
                 event: "Optional[torch.cuda.Event]" = None,
                 frame: int = 0):
        self.tensor = tensor
        self.event = event
        self.frame = frame

    def wait(self) -> torch.Tensor:
        """The device tensor, usable on the current stream: makes the
        current stream wait on the copy's event (the host does not) and
        records the tensor, made on the side stream, as used by the
        current stream."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.tensor.device)
            cur.wait_event(self.event)
            self.tensor.record_stream(cur)
            self.event = None
        return self.tensor


def _host_parts(frames) -> Tuple[List[np.ndarray], tuple, torch.dtype]:
    """The C-contiguous host arrays of one frame, or of a list of frames
    to stack, with the shape and torch type they make; raises if the
    frames of a list differ in shape or type, or a type has no torch
    counterpart."""
    stacked = isinstance(frames, (list, tuple))
    parts = [np.ascontiguousarray(f)
             for f in (frames if stacked else [frames])]
    if not parts:
        raise ValueError("no frame to stage")
    first = parts[0]
    for p in parts[1:]:
        if p.shape != first.shape or p.dtype != first.dtype:
            raise ValueError(f"frame {p.shape} {p.dtype} does not stack "
                             f"with {first.shape} {first.dtype}")
    dtype = torch.from_numpy(first[:0]).dtype
    shape = (len(parts),) + first.shape if stacked else first.shape
    return parts, shape, dtype


class HostStager:
    """Host-to-device copies that cost the caller's thread a few enqueues,
    as ``jax.device_put`` does.

    :meth:`put` takes a host frame, or a list of frames to stack (K, H,
    W). On a CUDA ``device`` it queues, on the stager's side stream, the
    copy of the frame into a pinned buffer (a host function on CUDA's
    callback thread: :func:`slc_tpu_torch.kernels.staging.stage_h2d`)
    and that buffer's copy to the device, records an event and returns.
    By default the copy goes into a fresh device tensor, whose
    :meth:`Staged.wait` makes the current stream wait on the event. With
    ``out`` (a device tensor of that shape, such as a slot of a graph's
    frame stack, which queued work may still read) the side stream first
    waits on the current stream, and the current stream then waits on the
    copy.

    The pinned buffers are a ring of ``slots`` per shape; stream order on
    the one side stream keeps a buffer from being written before its last
    device copy has read it. The stager holds each frame until its copy
    has completed; the caller's thread waits only when ``slots`` copies
    are in flight. A failed build or launch raises. On the CPU ``put``
    copies the frame into a tensor of its own, or into ``out``.

    Spans (:mod:`slc_tpu_torch.metrics`): ``stream.put``, each call whole,
    its ``frame`` the put's ordinal; ``stream.ring_wait``, the wait for
    copies to complete inside it. On the CPU the copy runs inside ``put``
    and counts as a staging job (``stage.jobs``, ``stage.copy_ns``) with
    no start delay."""

    def __init__(self, device, slots: int = 3):
        if slots < 2:
            raise ValueError(f"a ring needs at least 2 buffers, got {slots}")
        self.device = torch.device(device)
        self.slots = slots
        self._rings: dict = {}
        self._puts = 0
        self._live: collections.deque = collections.deque()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def put(self, frames, out: Optional[torch.Tensor] = None) -> Staged:
        self._puts += 1
        with metrics.span("stream.put", frame=self._puts):
            return self._put(frames, out, self._puts)

    def _put(self, frames, out: Optional[torch.Tensor],
             ordinal: int) -> Staged:
        parts, shape, dtype = _host_parts(frames)
        if out is not None and (tuple(out.shape) != shape
                                or out.dtype != dtype
                                or out.device.type != self.device.type):
            raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                             f"{out.device} does not take {shape} {dtype} "
                             f"on {self.device}")
        if self._stream is None:
            timed = metrics.recording()
            t0 = time.perf_counter_ns() if timed else 0
            t = torch.from_numpy(np.stack(parts).reshape(shape))
            t = t if out is None else out.copy_(t)
            if timed:
                # The staging copy runs here, inside the call: a job with
                # no start delay.
                metrics.count("stage.jobs")
                metrics.count("stage.copy_ns", time.perf_counter_ns() - t0)
            return Staged(t, frame=ordinal)
        ring = self._rings.get((shape, dtype))
        if ring is None:
            ring = self._rings[(shape, dtype)] = [0, [
                torch.empty(shape, dtype=dtype, pin_memory=True)
                for _ in range(self.slots)]]
        host = ring[1][ring[0] % self.slots]
        ring[0] += 1
        # Frames whose copy has completed are let go; with a full ring the
        # oldest copy is waited for.
        with metrics.span("stream.ring_wait"):
            while self._live and (len(self._live) >= self.slots
                                  or self._live[0][0].query()):
                self._live.popleft()[0].synchronize()
        current = torch.cuda.current_stream(self.device)
        if out is not None:
            self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            dev = out if out is not None else torch.empty(
                shape, dtype=dtype, device=self.device)
            kstaging.stage_h2d(parts, host, dev)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._live.append((event, parts))
        if out is None:
            return Staged(dev, event, ordinal)
        current.wait_event(event)
        return Staged(out, frame=ordinal)


@dataclasses.dataclass
class Fetched:
    """One frame's result with its depth map on its way to the host:
    ``result`` stays on the device; ``z`` waits for the pinned copy and
    returns it."""
    result: FrameResult
    z_host: torch.Tensor
    ready: "torch.cuda.Event"

    @property
    def z(self) -> torch.Tensor:
        """z on the host, waited for (the span ``stream.fetch_wait``)."""
        with metrics.span("stream.fetch_wait"):
            self.ready.synchronize()
        return self.z_host


def fetch_z_async(res: FrameResult):
    """The default ``fetch`` of :func:`stream_frames`: on the card, start
    the copy of z into pinned host memory on the current stream and
    return a :class:`Fetched`; on the CPU, the result itself. Its host
    time is the span ``stream.fetch``."""
    with metrics.span("stream.fetch"):
        z = res.z
        if z.device.type == "cpu":
            return res
        host = torch.empty(z.shape, dtype=z.dtype, pin_memory=True)
        host.copy_(z, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(z.device))
        return Fetched(res, host, ready)


def stream_frames(state: TrackerState, frames: Iterable[np.ndarray],
                  tables: TriangulationTables, cfg: SystemConfig,
                  fetch: Optional[Callable[[FrameResult], object]] = None,
                  scale_gradient: bool = True, subpixel: bool = True,
                  robust: bool = True
                  ) -> Iterator[Tuple[TrackerState, object]]:
    """Pipelined streaming loop over host uint8 frames. Yields (state,
    fetched) per frame where ``fetched`` is ``fetch(result)`` (default:
    :func:`fetch_z_async`).

    The yielded state of frame f is NOT synchronized; callers needing
    host values must wait for it (the checkpoint path's ``.cpu()``
    does). Each step returns fresh maps, so a yielded state stays valid
    as the iteration advances."""
    if fetch is None:
        fetch = fetch_z_async
    stager = HostStager(state.z.device)
    for staged in one_ahead(stager.put(frame) for frame in frames):
        state, res = dynamic_step(state, staged.wait(), tables, cfg,
                                  scale_gradient, subpixel, robust)
        yield state, fetch(res)


def one_ahead(items: Iterable) -> Iterator:
    """``items`` (none of them None) handed on one behind: each only once
    the next has been made, the last at the end. Over a generator of
    ``HostStager.put`` calls, frame f+1's copy is started before frame f
    is handed on to its step."""
    pending = None
    for item in items:
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


def _cuda_device(device) -> torch.device:
    """``device`` with its index (the wrappers' caches key on it)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _graph_key(steps, slots, h, w, device, cfg, scale_gradient, subpixel,
               robust, phase_lock, lock_win_u, lock_win_v, frac_bits):
    """What a captured graph is made for: the replays of one graph serve
    only calls that give the same key (and the same tables)."""
    return (steps, slots, h, w, str(_cuda_device(device)), cfg.reco_window,
            cfg.fov_min, cfg.fov_max, bool(scale_gradient), bool(subpixel),
            bool(robust), None if phase_lock is None else float(phase_lock),
            int(lock_win_u), int(lock_win_v), int(frac_bits))


class ChunkGraph:
    """``steps`` tracker steps captured into one CUDA graph.

    Static inputs: ``frames`` (``frame_slots``, H, W) uint8, step i
    reading slot i % frame_slots, and the carried (proj_u, strip_w,
    strip_b). Static outputs: ``zs``, ``xs``, ``ys`` (``out_slots``, H,
    W), step i writing slot i % out_slots, and the final carried maps,
    which alternate between the input maps and a second set (a step's
    outputs never overlap its inputs). A chunk is ``frame_slots =
    out_slots = steps``; ``measure_overlap``'s repeated step on one
    frame is ``frame_slots = out_slots = 1``.

    Before the capture the library is loaded and, for the lock, its
    triangle weights made (their first use copies from the host, which
    a capturing stream does not allow). The lock's scratch is allocated
    inside the capture, in the graph's memory pool. The graph, its pool
    and its buffers live as long as this object, which its caller owns:
    nothing else keeps it."""

    def __init__(self, steps: int, frame_slots: int, out_slots: int,
                 h: int, w: int, device, tables: TriangulationTables,
                 cfg: SystemConfig, scale_gradient: bool, subpixel: bool,
                 robust: bool, phase_lock: Optional[float],
                 lock_win_u: int, lock_win_v: int, frac_bits: int):
        self.steps = steps
        self.tables = tables        # the graph reads its maps
        self.key = _graph_key(steps, frame_slots, h, w, device, cfg,
                              scale_gradient, subpixel, robust, phase_lock,
                              lock_win_u, lock_win_v, frac_bits)
        dev = _cuda_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.frames = torch.zeros((frame_slots, h, w), dtype=torch.uint8,
                                  device=dev)
        # Both sets of carried maps and every buffer the graph writes stay
        # referenced here: the replays write them at the captured
        # addresses, so the allocator must never hand them out again.
        self.carried = [torch.zeros((h, w), **f32) for _ in range(3)]
        self.other = [torch.zeros((h, w), **f32) for _ in range(3)]
        self.zs, self.xs, self.ys = (torch.zeros((out_slots, h, w), **f32)
                                     for _ in range(3))
        self.wrapper = (kstep.dynamic_step_lock_cuda if phase_lock is not None
                        else kstep.dynamic_step_open_cuda)
        if phase_lock is not None:
            kstep.lock_buffers(h, w, lock_win_u, lock_win_v, dev)
        else:
            _build.lib()
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        before = self.wrapper.launches
        src, dst = self.carried, self.other
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                for i in range(steps):
                    j = i % out_slots
                    st = TrackerState(proj_u=src[0], strip_w=src[1],
                                      strip_b=src[2], z=self.zs[j],
                                      frame_idx=0)
                    step_maps(st, self.frames[i % frame_slots], tables, cfg,
                              scale_gradient, subpixel, robust, phase_lock,
                              lock_win_u, lock_win_v, frac_bits,
                              out=(*dst, self.zs[j], self.xs[j],
                                   self.ys[j]))
                    src, dst = dst, src
        finally:
            self.wrapper.launches = before
        self.final = src
        self.last = (steps - 1) % out_slots

    def run(self, state: TrackerState, frames: torch.Tensor
            ) -> Tuple[TrackerState, Tuple[torch.Tensor, ...]]:
        """Copy ``frames`` (unless it is :attr:`frames` itself, staged
        there already) and the carried maps of ``state`` into the graph's
        inputs, replay it on the current stream, and return the new state
        (copies, owned by the caller) and the output stacks (the graph's
        buffers)."""
        if frames is not self.frames:
            self.frames.copy_(frames.reshape(self.frames.shape))
        for dst, src in zip(self.carried,
                            (state.proj_u, state.strip_w, state.strip_b)):
            dst.copy_(src)
        self.graph.replay()
        self.wrapper.launches += self.steps
        pu, sw, sb = (t.clone() for t in self.final)
        new = TrackerState(proj_u=pu, strip_w=sw, strip_b=sb,
                           z=self.zs[self.last].clone(),
                           frame_idx=state.frame_idx + self.steps)
        return new, (self.zs, self.xs, self.ys)


def chunk_graph(steps: int, h: int, w: int, device,
                tables: TriangulationTables, cfg: SystemConfig,
                scale_gradient: bool = True, subpixel: bool = True,
                robust: bool = True, phase_lock: Optional[float] = None,
                lock_win_u: int = 9, lock_win_v: int = 9,
                frac_bits: int = 0, repeat: bool = False) -> ChunkGraph:
    """Capture the graph of ``steps`` steps at (h, w) with these flags (a
    chunk, or with ``repeat`` the steps on one frame). Capturing launches
    nothing; a runner captures during its warm-up, so that the first
    chunk's time holds no capture, and passes the graph to every
    :func:`chunk_step_xyz` of its run (each graph holds its buffers:
    ~0.25 GB for a chunk of 16 at 1024x1280)."""
    slots = 1 if repeat else steps
    return ChunkGraph(steps, slots, slots, h, w, device, tables, cfg,
                      scale_gradient, subpixel, robust,
                      None if phase_lock is None else float(phase_lock),
                      lock_win_u, lock_win_v, frac_bits)


def chunk_step_xyz(state: TrackerState, frames: torch.Tensor,
                   tables: TriangulationTables, cfg: SystemConfig,
                   scale_gradient: bool = True, subpixel: bool = True,
                   robust: bool = True, phase_lock=None,
                   lock_win_u: int = 9, lock_win_v: int = 9,
                   frac_bits: int = 0, graph: Optional[ChunkGraph] = None
                   ) -> Tuple[TrackerState, Tuple[torch.Tensor, ...]]:
    """K dynamic steps over a (K, H, W) uint8 frame stack, returning the
    new state and the per-frame outputs (z, x, y) stacked (K, H, W): the
    runner's chunked megastep (``run --chunk``). On the card one replay
    of ``graph`` (from :func:`chunk_graph` with the same arguments;
    without one, a graph captured for this call alone), whose output
    buffers the stacks are (module note); on the CPU a loop over
    ``dynamic_step``."""
    if frames.ndim != 3 or frames.shape[0] < 1:
        raise ValueError(f"frames: expected a (K, H, W) stack, got "
                         f"{tuple(frames.shape)}")
    k, h, w = frames.shape
    if frames.device.type == "cpu":
        outs = []
        for f in frames:
            state, res = dynamic_step(state, f, tables, cfg, scale_gradient,
                                      subpixel, robust,
                                      phase_lock=phase_lock,
                                      lock_win_u=lock_win_u,
                                      lock_win_v=lock_win_v,
                                      frac_bits=frac_bits)
            outs.append(res)
        return state, tuple(torch.stack([getattr(r, a) for r in outs])
                            for a in ("z", "x", "y"))
    args = (scale_gradient, subpixel, robust, phase_lock, lock_win_u,
            lock_win_v, frac_bits)
    if graph is None:
        graph = chunk_graph(k, h, w, frames.device, tables, cfg, *args)
    elif graph.tables is not tables or graph.key != _graph_key(
            k, k, h, w, frames.device, cfg, *args):
        raise ValueError("graph: captured for other shapes, flags or "
                         "tables than this call's")
    return graph.run(state, frames)


def _chunk_scan(state: TrackerState, frames: torch.Tensor,
                tables: TriangulationTables, cfg: SystemConfig,
                scale_gradient: bool, subpixel: bool, robust: bool,
                phase_lock=None, lock_win_u: int = 9, lock_win_v: int = 9,
                graph: Optional[ChunkGraph] = None
                ) -> Tuple[TrackerState, torch.Tensor]:
    """K dynamic steps in one call, returning the K depth maps stacked
    (the z-only variant of :func:`chunk_step_xyz`, on the same graph)."""
    state, (zs, _, _) = chunk_step_xyz(state, frames, tables, cfg,
                                       scale_gradient, subpixel, robust,
                                       phase_lock, lock_win_u, lock_win_v,
                                       graph=graph)
    return state, zs


def stream_chunks(state: TrackerState, frames: Iterable,
                  tables: TriangulationTables, cfg: SystemConfig,
                  chunk: int,
                  scale_gradient: bool = True, subpixel: bool = True,
                  robust: bool = True, phase_lock=None,
                  lock_win_u: int = 9, lock_win_v: int = 9
                  ) -> Iterator[Tuple[TrackerState, torch.Tensor]]:
    """Chunked streaming megastep: K frames per call of
    :func:`_chunk_scan`, with the NEXT chunk's host-to-device copy issued
    before the current chunk runs, so the copy overlaps its steps.

    Yields (state, z_stack) per chunk, z_stack (k, H, W) float32 with k
    == ``chunk`` except for a possibly smaller final chunk, which runs
    frame at a time through the single step (no graph of another size).
    Frames may be host numpy arrays (staged through pinned memory, one
    copy per chunk) or device tensors (stacked on the device). On the
    card the chunks replay one graph, captured at the first and freed
    when the iteration ends; a full chunk's z_stack is its buffer, valid
    until the next chunk (module note); the yielded states are the
    caller's.

    The frame-to-frame dependency P[f] = P[f-1] + deltaP
    (CCalculation.cpp:656-660) is kept exactly: chunking changes how
    the steps are launched, not their order or inputs."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    stager = HostStager(state.z.device)
    graph = None

    def put(buf):
        if isinstance(buf[0], torch.Tensor):
            return Staged(torch.stack(buf))  # on the device
        return stager.put(buf)

    def scan(st, staged):
        nonlocal graph
        stack = staged.wait()
        if stack.device.type == "cuda" and graph is None:
            graph = chunk_graph(chunk, *stack.shape[1:], stack.device,
                                tables, cfg, scale_gradient, subpixel,
                                robust, phase_lock, lock_win_u, lock_win_v)
        return _chunk_scan(st, stack, tables, cfg, scale_gradient, subpixel,
                           robust, phase_lock, lock_win_u, lock_win_v,
                           graph=graph)

    pending = None
    buf: list = []
    for f in frames:
        buf.append(f)
        if len(buf) == chunk:
            staged = put(buf)               # H2D of chunk i+1
            buf = []
            if pending is not None:
                state, zs = scan(state, pending)
                yield state, zs
            pending = staged
    if pending is not None:
        state, zs = scan(state, pending)
        yield state, zs
    for f in buf:
        # Ragged tail: the single step.
        dev = f if isinstance(f, torch.Tensor) else stager.put(f).wait()
        state, res = dynamic_step(state, dev, tables, cfg, scale_gradient,
                                  subpixel, robust, phase_lock=phase_lock,
                                  lock_win_u=lock_win_u,
                                  lock_win_v=lock_win_v)
        yield state, res.z[None]


def _sync(device: torch.device) -> None:
    """Wait for everything queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy(s: TrackerState) -> TrackerState:
    return dataclasses.replace(s, proj_u=s.proj_u.clone(),
                               strip_w=s.strip_w.clone(),
                               strip_b=s.strip_b.clone(), z=s.z.clone())


def measure_overlap(state: TrackerState, frames: List[np.ndarray],
                    tables: TriangulationTables, cfg: SystemConfig,
                    scale_gradient: bool = True, subpixel: bool = True,
                    compute_repeats: "int | str" = 1) -> dict:
    """Quantify transfer/compute overlap in the streaming loop
    (slc_tpu/streaming.py:226-413, the same legs and formulas).

    Per-frame times over the same frame list, each leg on the host clock
    ending in a synchronize of the device:

      * ``compute_ms``  — frames pre-staged on the device, steps back to
        back (pure compute).
      * ``transfer_ms`` — every frame staged through the pinned ring and
        copied to the device, no compute (pure transfer).
      * ``pipelined_ms``— the :func:`stream_frames` structure: frame f+1
        staged while frame f's step runs.
      * ``sequential_ms``— the reference-style strict loop: wait for the
        transfer, then for the step, per frame.

    ``overlap_efficiency`` = (compute + transfer - pipelined) /
    min(compute, transfer), clamped to [0, 1]. ``compute_repeats`` R > 1
    runs R open-loop steps per frame (one CUDA graph replay on the card,
    a loop on the CPU) so the compute leg scales into the transfer
    leg's range; "auto" calibrates R from single-leg probes, then
    refines it from the repeated step as measured, aiming compute at
    1.5x transfer. ``leg_ratio`` = min/max of the two legs; ``regime``
    is "balanced" at leg_ratio >= 0.2, else the dominant leg. All
    timings exclude warm-up, library build and graph capture."""
    frames = list(frames)
    assert len(frames) >= 2, "need >=2 frames to measure overlap"
    stager = HostStager(state.z.device)
    n = len(frames)
    device = state.z.device
    h, w = np.asarray(frames[0]).shape

    def single_step(st, dev):
        return dynamic_step(st, dev, tables, cfg, scale_gradient, subpixel)

    graphs: dict = {}       # R -> the repeated step's graph, this call's

    def repeat_step(st, dev, reps):
        if device.type == "cpu":
            for _ in range(reps):
                st, _ = single_step(st, dev)
            return st
        if reps not in graphs:
            graphs[reps] = chunk_graph(reps, h, w, device, tables, cfg,
                                       scale_gradient, subpixel, repeat=True)
        return graphs[reps].run(st, dev)[0]

    # Warm-up (library build) on a copy of the state.
    st = _copy(state)
    st, _ = single_step(st, stager.put(frames[0]).wait())
    _sync(device)

    if compute_repeats == "auto":
        st = _copy(state)
        d0 = stager.put(frames[0]).wait()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(4):
            st, _ = single_step(st, d0)
        _sync(device)
        step_s = (time.perf_counter() - t0) / 4
        t0 = time.perf_counter()
        devs = [d.wait() for d in [stager.put(f) for f in frames[:4]]]
        _sync(device)
        h2d_s = (time.perf_counter() - t0) / len(devs)
        compute_repeats = int(np.clip(round(h2d_s / max(step_s, 1e-9)),
                                      1, 1024))
        reps0 = int(compute_repeats)
        if reps0 > 1:
            st = repeat_step(_copy(state), d0, reps0)     # capture
            _sync(device)
            st = _copy(state)
            t0 = time.perf_counter()
            for _ in range(4):
                st = repeat_step(st, d0, reps0)
            _sync(device)
            rep_s = (time.perf_counter() - t0) / 4
            compute_repeats = int(np.clip(
                round(1.5 * reps0 * h2d_s / max(rep_s, 1e-9)), 1, 4096))
        del devs
    reps = int(compute_repeats)

    def step(st, dev):
        if reps == 1:
            return single_step(st, dev)
        return repeat_step(st, dev, reps), None

    if reps > 1:   # capture the repeated step out of the timed region
        st, _ = step(_copy(state), stager.put(frames[0]).wait())
        _sync(device)

    # Pure compute: pre-staged device frames.
    dev_frames = [stager.put(f).wait() for f in frames]
    st = _copy(state)
    _sync(device)
    t0 = time.perf_counter()
    for d in dev_frames:
        st, _ = step(st, d)
    _sync(device)
    compute_s = (time.perf_counter() - t0) / n
    del dev_frames

    # Pure transfer.
    t0 = time.perf_counter()
    devs = [d.wait() for d in [stager.put(f) for f in frames]]
    _sync(device)
    transfer_s = (time.perf_counter() - t0) / n
    del devs

    # Pipelined loop (the product path's structure).
    st = _copy(state)
    _sync(device)
    t0 = time.perf_counter()
    for staged in one_ahead(stager.put(f) for f in frames):
        st, _ = step(st, staged.wait())
    _sync(device)
    pipelined_s = (time.perf_counter() - t0) / n

    # Strict sequential loop (what the reference does).
    st = _copy(state)
    _sync(device)
    t0 = time.perf_counter()
    for f in frames:
        d = stager.put(f).wait()
        _sync(device)
        st, _ = step(st, d)
        _sync(device)
    sequential_s = (time.perf_counter() - t0) / n

    hidden = compute_s + transfer_s - pipelined_s
    eff = hidden / max(min(compute_s, transfer_s), 1e-12)
    leg_ratio = (min(compute_s, transfer_s)
                 / max(compute_s, transfer_s, 1e-12))
    if leg_ratio >= 0.2:
        regime = "balanced"
    elif transfer_s > compute_s:
        regime = "transfer_bound"
    else:
        regime = "compute_bound"
    return {
        "frames": n,
        "compute_ms": round(compute_s * 1e3, 3),
        "transfer_ms": round(transfer_s * 1e3, 3),
        "pipelined_ms": round(pipelined_s * 1e3, 3),
        "sequential_ms": round(sequential_s * 1e3, 3),
        "overlap_efficiency": round(max(0.0, min(1.0, eff)), 3),
        "speedup_vs_sequential": round(sequential_s
                                       / max(pipelined_s, 1e-12), 3),
        "compute_repeats": reps,
        # Three significant digits, where slc_tpu rounds to 3 decimals:
        # a CPU run's ratio (~1e-3) then stays above 0.
        "leg_ratio": float(f"{leg_ratio:.3g}"),
        "regime": regime,
    }


def _block(t: torch.Tensor) -> None:
    """Wait for the work queued so far on ``t``'s device's current stream
    (a no-op on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def run_streaming(state: TrackerState, frames: Iterable[np.ndarray],
                  tables: TriangulationTables, cfg: SystemConfig,
                  sync_every: int = 1,
                  scale_gradient: bool = True, subpixel: bool = True,
                  fetch: Optional[Callable[[FrameResult], object]] = None,
                  chunk: int = 1,
                  fetch_z: Optional[Callable[[torch.Tensor], object]] = None,
                  robust: bool = True
                  ) -> Tuple[TrackerState, StreamStats]:
    """Drive the streaming loop measuring per-frame wall latency
    (slc_tpu/streaming.py:416-486). ``scale_gradient``/``subpixel``/
    ``robust`` mirror dynamic_step's tracker flags.

    ``sync_every`` = N waits for the carried depth map every N frames
    (N=1 measures per-frame latency; larger N pipelined throughput).
    ``fetch`` overrides the per-frame result consumer (default:
    :func:`fetch_z_async`). ``chunk`` > 1 switches to
    :func:`stream_chunks`: one graph replay and one wait per K frames;
    ``fetch_z`` is then the consumer of each (k, H, W) z stack (default:
    none, it stays on the device). Per-frame ``fetch``/``sync_every`` do
    not apply in chunked mode and raise ValueError if passed.
    """
    lat: List[float] = []
    if chunk > 1:
        if fetch is not None or sync_every != 1:
            raise ValueError(
                "chunk > 1 uses the chunked megastep: per-frame "
                "`fetch`/`sync_every` do not apply (pass `fetch_z` "
                "for the per-chunk consumer)")
        chunk_lat: List[float] = []
        chunk_sizes: List[int] = []
        t0 = time.perf_counter()
        for state, zs in stream_chunks(state, frames, tables, cfg, chunk,
                                       scale_gradient=scale_gradient,
                                       subpixel=subpixel, robust=robust):
            if fetch_z is not None:
                fetch_z(zs)
            _block(state.z)
            now = time.perf_counter()
            k = int(zs.shape[0])
            chunk_lat.append(now - t0)
            chunk_sizes.append(k)
            lat.extend([(now - t0) / k] * k)
            t0 = now
        return state, StreamStats(lat, chunk_lat, chunk_sizes)

    t0 = time.perf_counter()
    last = None
    for i, (state, res) in enumerate(
            stream_frames(state, frames, tables, cfg, fetch=fetch,
                          scale_gradient=scale_gradient,
                          subpixel=subpixel, robust=robust)):
        last = res
        if (i + 1) % sync_every == 0:
            _block(state.z)
            now = time.perf_counter()
            dt = (now - t0) / sync_every
            lat.extend([dt] * sync_every)
            t0 = now
    if last is not None:
        _block(state.z)
    return state, StreamStats(lat)
