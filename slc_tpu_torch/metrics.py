"""Structured per-frame metrics, stage timing, and the program's spans
and counters (PyTorch port of slc_tpu/metrics.py).

Every frame yields a record (valid-pixel fraction, z range, wall-clock
fps) and the runner's stages are timed by :func:`stage`.

Spans and counters. :func:`span` marks a stretch of host work inside the
program (``stream.put``, ``track.step``, ``kernel.launch``, ...) and
:func:`count` adds to a named integer. Both record only while a
``torch.profiler`` session runs in the process; there is no other
switch. Outside one, a span is one check and a shared null context: no
clock is read and nothing is allocated. Inside one, a span opens a
profiler range ``slc.<name>`` (a CPU op on the profiler's clock, with
no mirror on the device's timeline; ``frame`` shows as its ``frame``
argument in a trace taken with ``record_shapes=True``) and adds its host
time to an aggregate per name: calls, total, self (total less the spans
opened inside it on the same thread) and max, in ns. No span waits for
the device: a span is host time, the device trace is device time. No
event list is kept; the timeline is in the profiler's records.
:func:`span_totals` and :func:`counters` read the aggregates (the
latter with the frame stager's host-function timings, ``stage.*``, once
the kernel library is loaded), :func:`reset` clears them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from slc_tpu_torch import devtime

_STATS = ("valid_frac", "z_min", "z_max", "z_mean")


def _stats_tensor(z: torch.Tensor) -> torch.Tensor:
    """The four per-frame stats of one depth map, as a (4,) tensor on its
    device."""
    valid = z > 0
    any_valid = valid.any()
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return torch.stack([
        valid.float().mean(),
        torch.where(any_valid, torch.where(valid, z, torch.inf).min(),
                    zero),
        torch.where(any_valid, torch.where(valid, z, -torch.inf).max(),
                    zero),
        torch.where(valid, z, zero).sum()
        / valid.sum().clamp(min=1).to(z.dtype),
    ])


def frame_stats(z: torch.Tensor) -> Dict[str, float]:
    """Per-frame stats of a depth map (z > 0 is valid), reduced on the
    device and read back in one transfer."""
    return dict(zip(_STATS, _stats_tensor(z).tolist()))


def frame_stats_many(zs) -> List[Dict[str, float]]:
    """:func:`frame_stats` of each depth map of ``zs`` (a (K, H, W) stack
    or a sequence of maps), the same reductions map by map, read back in
    one transfer for all of them."""
    rows = torch.stack([_stats_tensor(z) for z in zs]).tolist()
    return [dict(zip(_STATS, row)) for row in rows]


@dataclasses.dataclass
class MetricsLog:
    """Accumulates per-frame records; writes JSON lines.

    Stage timings recorded via :func:`stage` between two ``log_frame``
    calls are folded into the next frame's record as ``t_<stage>_ms``
    (and ``gbps_<stage>`` when the bytes moved are known).
    """

    records: List[dict] = dataclasses.field(default_factory=list)
    #: Run-level summary records (the async writer's totals, the period
    #: diagnostic); written after the frame records.
    summaries: List[dict] = dataclasses.field(default_factory=list)
    _t_last: Optional[float] = None
    _pending_stages: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def log_stage(self, name: str, wall_s: float,
                  bytes_moved: Optional[int] = None) -> None:
        """Record one stage timing, attached to the next log_frame."""
        short = name.rsplit("/", 1)[-1]
        entry = {f"t_{short}_ms": round(wall_s * 1e3, 3)}
        if bytes_moved is not None and wall_s > 0:
            gbps = bytes_moved / wall_s / 1e9
            entry[f"gbps_{short}"] = float(f"{gbps:.3g}")
        self._pending_stages.update(entry)

    def log_frame(self, frame_idx: int, stats: Dict[str, float],
                  **extra) -> dict:
        now = time.perf_counter()
        fps = (1.0 / (now - self._t_last)
               if self._t_last is not None else None)
        self._t_last = now
        rec = {"frame": int(frame_idx),
               **{k: float(v) for k, v in stats.items()},
               **self._pending_stages,
               **extra}
        self._pending_stages = {}
        if fps is not None:
            rec["fps"] = round(fps, 2)
        self.records.append(rec)
        return rec

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records + self.summaries:
                f.write(json.dumps(rec) + "\n")


#: Whether a profiler session runs in this process: the spans' switch.
recording = torch.autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
#: name -> [calls, total ns, self ns, max ns]
_spans: Dict[str, List[int]] = {}
_counts: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str, frame: Optional[int]):
        self.name = name
        self.rf = _RecordFunctionFast(
            "slc." + name, (), {} if frame is None else {"frame": int(frame)})
        self.inner = 0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.inner
            if dt > agg[3]:
                agg[3] = dt
        return False


def span(name: str, frame: Optional[int] = None):
    """A context manager marking host work named ``name`` (``frame``: the
    frame it serves, if any); records only while a profiler runs."""
    if not recording():
        return _NULL
    return _Span(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if recording():
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def span_totals() -> Dict[str, Dict[str, int]]:
    """Each span's aggregate since the last :func:`reset`: ``calls``,
    ``total_ns``, ``self_ns`` and ``max_ns``."""
    with _lock:
        return {k: dict(zip(("calls", "total_ns", "self_ns", "max_ns"), v))
                for k, v in _spans.items()}


def counters() -> Dict[str, int]:
    """Each counter since the last :func:`reset`, plus the frame stager's
    host-function timings (``stage.*``, kept by the kernel library for
    the copies queued while a profiler ran) where the library is loaded
    and has timed a copy."""
    from slc_tpu_torch.kernels import _build     # it imports this module
    with _lock:
        out = dict(_counts)
    stats = _build.stage_stats()
    if stats is not None and stats["stage.jobs"]:
        for k, v in stats.items():
            out[k] = out.get(k, 0) + v
    return out


def reset() -> None:
    """Clear the spans and counters, the kernel library's stager timings
    included."""
    from slc_tpu_torch.kernels import _build
    with _lock:
        _spans.clear()
        _counts.clear()
    _build.stage_stats(reset=True)


@contextlib.contextmanager
def stage(name: str, log: Optional[MetricsLog] = None,
          bytes_moved: Optional[int] = None, device=None):
    """Wall clock of a runner stage, its host work also a span named
    ``stage.<last part of name>``. On a CUDA ``device`` the block ends by
    synchronizing the device's current stream, outside the span, so the
    wall time covers the device work launched inside it, not just its
    enqueueing, and not a copy that another stream runs meanwhile (the
    streaming loop's transfer of the next frame)."""
    device = torch.device(device) if device is not None else None
    t0 = time.perf_counter()
    with span("stage." + name.rsplit("/", 1)[-1]):
        yield
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    wall = time.perf_counter() - t0
    if log is not None:
        log.log_stage(name, wall, bytes_moved)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace into ``log_dir`` (``trace_<pid>_<ns>.json``; slc_tpu's
    ``jax.profiler`` trace). On a CUDA ``device`` the trace holds CPU and
    CUDA activity; where CUPTI cannot trace the card, it raises
    ``devtime.ProfilerUnavailable`` before the block runs and writes
    nothing. ``device="cpu"`` traces CPU activity alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not devtime.profiler_sees_cuda():
            raise devtime.ProfilerUnavailable(
                "torch.profiler records no CUDA kernel in this process "
                "(CUPTI tracing is not available): no device trace")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
